"""The whole render path of the port against the JAX package, on the CPU:
SyntheticPlanesDataset at 32x64 with 3 source views -> shim -> PixelSplat
forward (deterministic), at __graft_entry__._tiny_cfg() widths with the
same weights. The JAX side renders with its "tiled" backend, as that config
sets; the port with its "cuda" backend, whose wrapper runs the plain
PyTorch compositor on CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ggrt_official_tpu.data import datasets as jds
from ggrt_official_tpu.data.shims import get_data_shim as jshim
from ggrt_official_tpu.models import pixelsplat as jps
from ggrt_official_torch import config as tcfg
from ggrt_official_torch import weights
from ggrt_official_torch.data import datasets as tds
from ggrt_official_torch.data.shims import get_data_shim as tshim
from ggrt_official_torch.models import decoder_splatting as tdec
from ggrt_official_torch.models import pixelsplat as tps
from tests.test_torch_models import port_cfg
from tests.test_torch_rasterizer import image_close

SPECS = {
    "default": dict(n_views=8, image_size=(32, 64)),
    "flagship": dict(n_views=8, image_size=(32, 64), binary_alpha=True, look_at_z=4.0,
                     rot_wobble_deg=6.0, arc_scale=1.4, texture_octaves=4, focal_factor=0.7,
                     plane_depths=(1.5, 8.0), plane_span="cover"),
}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.tensor(tree) if isinstance(tree, np.ndarray) else tree


@pytest.fixture(scope="module")
def both():
    cfg = graft._tiny_cfg()
    pcfg = port_cfg(cfg)
    example = jds.collate_batch(jds.SyntheticPlanesDataset(
        jds.SyntheticSceneSpec(**SPECS["default"]), num_source_views=3)[0])
    jbatch = jshim(cfg.encoder)({"context": example["context"], "target": example["target"]})
    jbatch = jax.tree_util.tree_map(jnp.asarray, jbatch)
    model = jps.PixelSplat(cfg.encoder, cfg.decoder)
    params = jax.jit(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b, 0, deterministic=True))(jbatch)

    @jax.jit
    def forward(p, b):
        ret, _ = model.apply(p, b, 0, deterministic=True)
        g = model.apply(p, b["context"], 0, deterministic=True, method=jps.PixelSplat.encode_pairs)
        return ret, g

    ret, gaussians = forward(params, jbatch)

    port = tps.PixelSplat(pcfg.encoder, pcfg.decoder, device="cpu")
    port.load_state_dict(weights.params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg.encoder))
    example_t = tds.collate_batch(tds.SyntheticPlanesDataset(
        tds.SyntheticSceneSpec(**SPECS["default"]), num_source_views=3)[0])
    tbatch = tshim(pcfg.encoder)({"context": example_t["context"], "target": example_t["target"]})
    tbatch = to_torch(tbatch)
    with torch.no_grad():
        tret, _ = port(tbatch, 0, deterministic=True)
        tg = port.encode_pairs(tbatch["context"], 0, deterministic=True)
    return dict(jret=ret, jg=gaussians, tret=tret, tg=tg, jbatch=jbatch, tbatch=tbatch)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_dataset_matches(spec):
    """Same seed, same arrays. The port blurs in numpy where the JAX package
    calls OpenCV: textures agree to float32 rounding of the blur sums, and
    the thresholded alpha masks exactly."""
    a = jds.SyntheticPlanesDataset(jds.SyntheticSceneSpec(**SPECS[spec]), num_source_views=3)
    b = tds.SyntheticPlanesDataset(tds.SyntheticSceneSpec(**SPECS[spec]), num_source_views=3)
    for (da, ta, aa), (db, tb, ab) in zip(a.planes, b.planes):
        assert da == db
        np.testing.assert_array_equal(ab, aa)
        np.testing.assert_allclose(tb, ta, rtol=0, atol=5e-5)
    np.testing.assert_allclose(b.images, a.images, rtol=0, atol=5e-5)
    ea, eb = a[0], b[0]
    for part in ("context", "target"):
        for key, value in ea[part].items():
            np.testing.assert_allclose(eb[part][key], value, rtol=0, atol=5e-5, err_msg=key)


def test_shim_matches(both):
    for part in ("context", "target"):
        for key, value in both["jbatch"][part].items():
            np.testing.assert_allclose(both["tbatch"][part][key].numpy(), np.asarray(value),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{part}.{key}")


@pytest.mark.parametrize("name", ["means", "covariances", "harmonics", "opacities"])
def test_gaussians_match(both, name):
    """rtol 1e-4 (atol 1e-5) for at least 99% of the elements; every
    element within rtol 1e-3, atol 1e-3. The rest is the reference's own
    float32 noise: the depth positional encoding amplifies the
    triangulation of near-parallel epipolar rays, which float32 gets wrong
    by up to 1% in both packages (test_torch_models.py
    ::test_triangulation_noise); it reaches the SH colour terms most."""
    ref = np.asarray(getattr(both["jg"], name))
    out = getattr(both["tg"], name).numpy()
    assert out.shape == ref.shape
    within = np.isclose(out, ref, rtol=1e-4, atol=1e-5)
    assert within.mean() >= 0.99, f"{within.mean():.4f} within rtol 1e-4"
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


def test_images_match(both):
    assert both["tret"]["rgb"].shape == (1, 1, 3, 32, 64)
    assert both["tret"]["depth"].shape == (1, 1, 32, 64)
    image_close(both["tret"]["rgb"].numpy(), np.asarray(both["jret"]["rgb"]), "rgb")
    image_close(both["tret"]["depth"].numpy(), np.asarray(both["jret"]["depth"]), "depth")


@pytest.mark.parametrize("shape,g,expected", [
    ((32, 64), 8192, 8192),     # 4 tiles: demand 8192, budget 32768
    ((64, 96), 16384, 8192),    # 8 tiles: demand 8192, under the 16384 budget
    ((128, 192), 147456, 4096),  # 32 tiles: the 131072-slot budget binds
    ((320, 448), 1146880, 1024),  # 160 tiles: no raise
])
def test_small_image_capacity_raise(shape, g, expected):
    cfg = tcfg.pretrain_config().decoder
    assert tdec.effective_max_per_tile(cfg, g, shape) == expected


def test_config_backends():
    assert tcfg.DecoderCfg().backend == "cuda"
    for name in ("pallas", "tiled", "reference"):
        tdec.DecoderSplatting(tcfg.DecoderCfg(backend=name))
    with pytest.raises(ValueError):
        tdec.DecoderSplatting(tcfg.DecoderCfg(backend="xla"))
    cfg = tcfg.load_config(overrides={"decoder.max_per_tile": "512", "encoder.predict_opacity": "true"})
    assert cfg.decoder.max_per_tile == 512 and cfg.encoder.predict_opacity is True
