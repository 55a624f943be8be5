"""The port's encoder dump (utils/encoder_visualizer.py) and its capture
taps against the JAX package's on the CPU, at __graft_entry__._dryrun_cfg()
widths with two epipolar-transformer layers (so that flax's order of the
attention taps, all cross-attention layers before the feed-forwards'
self-attention, differs from the call order), 32x64, 3 source views.

The weights are made by the JAX package and reach the port through
`weights.ggrt_params_from_jax`. JAX's dump runs with Pallas in interpret
mode, its apply jitted. Each test states its tolerance.
"""
import copy
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

import __graft_entry__ as graft
from ggrt_official_tpu.data import datasets as jds
from ggrt_official_tpu.models.ggrt import GGRtModel as JModel
from ggrt_official_tpu.training.trainer import GGRtTrainer as JTrainer
from ggrt_official_tpu.utils import encoder_visualizer as jev
from ggrt_official_torch import weights
from ggrt_official_torch.data import datasets as tds
from ggrt_official_torch.data.shims import get_data_shim
from ggrt_official_torch.models import ggrt as tggrt
from ggrt_official_torch.models.depth_predictor import DepthPredictorMonocular
from ggrt_official_torch.models.transformer import Attention
from ggrt_official_torch.training.trainer import prepare_batch
from ggrt_official_torch.utils import encoder_visualizer as tev
from tests.test_torch_models import port_cfg
from tests.test_torch_rasterizer import image_close

IMAGE = (32, 64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dataset_example(pkg):
    return pkg.collate_batch(pkg.SyntheticPlanesDataset(
        pkg.SyntheticSceneSpec(n_views=8, image_size=IMAGE), num_source_views=3)[0])


class JittedGaussianForward:
    """Stands in for the JAX model in jev.dump_encoder_visualizations: the
    same apply (gaussian_forward with the intermediates collection), jitted."""

    def __init__(self, model):
        self._apply = jax.jit(lambda p, b: model.apply(p, b, 0, deterministic=True, method="gaussian_forward",
                                                       mutable=["intermediates"]))
        self.intermediates = None

    def apply(self, params, batch, step, deterministic, rngs, method, mutable):
        assert (step, deterministic, method, mutable) == (0, True, "gaussian_forward", ["intermediates"])
        out = self._apply(params, batch)
        self.intermediates = out[1]["intermediates"]
        return out


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    cfg = graft._dryrun_cfg()
    cfg.encoder.epipolar_transformer.num_layers = 2
    init_cfg = copy.deepcopy(cfg)
    init_cfg.decoder.backend = "tiled"
    jb = JTrainer(init_cfg).prepare_batch(dataset_example(jds))
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    gauss = jax.jit(lambda b: JModel(init_cfg).init({"params": k1, "sample": k2}, b, 0, deterministic=True,
                                                     method="gaussian_forward"))(jb)
    params = {"params": {"gaussian": gauss["params"]["gaussian"]}}
    jdir = tmp_path_factory.mktemp("jax_dump")
    jmodel = JittedGaussianForward(JModel(cfg))
    with pltpu.force_tpu_interpret_mode():
        want = jev.dump_encoder_visualizations(jmodel, params, jb, 0, IMAGE, out_dir=str(jdir))
    flat = jax.tree_util.tree_flatten_with_path(jmodel.intermediates)[0]
    taps = {name: [np.asarray(v) for p, v in flat if name in str(p)] for name in ("attn", "depth_pdf")}

    pcfg = port_cfg(cfg)
    model = tggrt.GGRtModel(pcfg, device="cpu")
    model.gaussian.load_state_dict(weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]["gaussian"]), pcfg.encoder))
    batch = prepare_batch(dataset_example(tds), get_data_shim(pcfg.encoder), "cpu")
    return dict(model=model, batch=batch, want=want, taps=taps, jdir=jdir)


def test_dump_images_from_jax_taps_are_jax_dump(case):
    """encoder_dumps on JAX's own taps and render gives JAX's dump: the same
    names, every image bit for bit (the same colour tables and indexing)."""
    got = tev.encoder_dumps(case["taps"]["attn"], case["taps"]["depth_pdf"],
                            np.asarray(case["want"]["rendered_rgb"]), IMAGE)
    assert sorted(got) == sorted(case["want"])
    for k, v in case["want"].items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_dump_matches_jax(case, tmp_path):
    """The whole dump on the port's model against JAX's, from the same
    weights and batch. The encoder's float32 triangulation noise (ROADMAP
    Queue 3; test_torch_models.py::test_epipolar_transformer) reaches the
    taps, so they are held to that test's bounds: more than 80% of the
    elements within rtol 1e-4, atol 1e-5, all within rtol 1e-2, atol 2e-3.
    The render is held by image_close. The images are min-max normalised
    and looked up in 256-entry tables, so a pixel whose value moves across
    an entry's edge takes the neighbouring colour: at least 95% of each
    image's pixels within 1e-5. The PNGs carry the same names and decode to
    the port's own images."""
    got = tev.dump_encoder_visualizations(case["model"], case["batch"], 0, IMAGE, out_dir=str(tmp_path))
    want = case["want"]
    assert sorted(got) == sorted(want)
    assert {"attention_l0_v0", "attention_l1_v3", "depth_pdf_v1", "rendered_rgb"} <= set(got)
    image_close(got["rendered_rgb"], np.asarray(want["rendered_rgb"]), "rendered_rgb")
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape and np.isfinite(got[k]).all(), k
        if k != "rendered_rgb":
            same = (np.abs(got[k] - np.asarray(want[k])) <= 1e-5).all(-1)
            assert same.mean() >= 0.95, (k, same.mean())
    with torch.no_grad(), tev.capture_intermediates(case["model"].gaussian) as taps:
        case["model"].gaussian(case["batch"], 0, deterministic=True)
    for name in ("attn", "depth_pdf"):
        assert len(taps[name]) == len(case["taps"][name])
        for a, b in zip(taps[name], case["taps"][name]):
            assert np.isclose(a.numpy(), b, rtol=1e-4, atol=1e-5).mean() > 0.8
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-2, atol=2e-3)
    pngs = sorted(os.listdir(tmp_path))
    assert pngs == sorted(os.listdir(case["jdir"])) and pngs
    for name in pngs:
        arr = got[name[:-4]]
        while arr.ndim > 3:
            arr = arr[0]
        if arr.shape[0] == 3:
            arr = arr.transpose(1, 2, 0)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / name)),
                                      (np.clip(arr, 0, 1) * 255).astype(np.uint8), err_msg=name)


def test_capture_is_off_outside_and_changes_nothing(case):
    """Outside capture_intermediates every tap is None; a forward with the
    taps on renders the same rgb as one without, bit for bit, and the taps
    come out in flax's order: the depth PDF, then both cross-attention
    layers, then each feed-forward's self-attention."""
    gaussian = case["model"].gaussian
    with torch.no_grad():
        plain, _ = gaussian(case["batch"], 0, deterministic=True)
        with tev.capture_intermediates(gaussian) as taps:
            captured, _ = gaussian(case["batch"], 0, deterministic=True)
    assert torch.equal(plain["rgb"], captured["rgb"])
    assert all(m.capture is None for m in gaussian.modules() if isinstance(m, (Attention, DepthPredictorMonocular)))
    assert [tuple(a.shape) for a in taps["attn"]] == [(512, 2, 1, 2)] * 2 + [(4, 2, 32, 32)] * 2
    assert [tuple(p.shape) for p in taps["depth_pdf"]] == [(2, 2, 2048, 1, 4)]
    assert not any(x.requires_grad for x in [*taps["attn"], *taps["depth_pdf"]])


def test_flax_path_order():
    """A transformer layer's attention and feed-forward take flax's names,
    attn_{i} and ff_{i}, so that sorting puts every attention layer first."""
    names = ["encoder.epipolar_transformer.transformer.layers.1.0.fn",
             "encoder.epipolar_transformer.transformer.layers.0.1.fn.self_attention.transformer.layers.0.0.fn",
             "encoder.epipolar_transformer.transformer.layers.0.0.fn", "encoder.depth_predictor"]
    assert [tev._flax_path(n)[3] if len(tev._flax_path(n)) > 3 else "dp" for n in sorted(names, key=tev._flax_path)] \
        == ["dp", "attn_0", "attn_1", "ff_0"]


def test_stochastic_dump_needs_a_generator(case):
    """Without `deterministic` the depth draws come from the caller's
    generator: the same seed gives the same dump, and no generator is an
    error, as JAX asserts an rng."""
    with pytest.raises(ValueError):
        tev.dump_encoder_visualizations(case["model"], case["batch"], 0, IMAGE, deterministic=False)
    a, b = (tev.dump_encoder_visualizations(case["model"], case["batch"], 0, IMAGE, deterministic=False,
                                            generator=torch.Generator().manual_seed(5)) for _ in range(2))
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_host_functions_are_jax():
    """The dump's host functions on the same seeded inputs (the Gaussians
    as CPU tensors on the port's side): equal to JAX's, bit for bit (the
    same numpy arithmetic and colour tables)."""
    from ggrt_official_torch.models.gaussian_adapter import Gaussians as TGaussians
    from ggrt_official_tpu.models.gaussian_adapter import Gaussians as JGaussians

    rng = np.random.RandomState(0)
    v, h, w, spp = 2, 4, 6, 3
    n = v * h * w * spp
    ext = np.tile(np.eye(4), (v, 1, 1))
    ext[:, :3, 3] = rng.randn(v, 3) * 0.1
    means = rng.randn(n, 3) + [0, 0, 4]
    np.testing.assert_array_equal(tev.visualize_depth_maps(means, ext, (h, w), spp),
                                  jev.visualize_depth_maps(means, ext, (h, w), spp))
    img, img2 = rng.rand(3, h, w).astype(np.float32), rng.rand(3, h, w).astype(np.float32)
    xy = rng.rand(5, 7, 2)
    np.testing.assert_array_equal(tev.overlay_epipolar_samples(img, xy), jev.overlay_epipolar_samples(img, xy))
    np.testing.assert_array_equal(tev.visualize_epipolar_color_samples(img, img2, xy),
                                  jev.visualize_epipolar_color_samples(img, img2, xy))
    attn = rng.dirichlet(np.ones(8), size=(h * w, 2))
    np.testing.assert_array_equal(tev.visualize_attention(attn, (h, w)), jev.visualize_attention(attn, (h, w)))
    valid = rng.rand(v, 1, h * w) > 0.3
    np.testing.assert_array_equal(tev.visualize_overlaps(valid, (h, w)), jev.visualize_overlaps(valid, (h, w)))
    pdf = rng.dirichlet(np.ones(16), size=h * w)
    np.testing.assert_array_equal(tev.visualize_probabilities(pdf, (h, w)), jev.visualize_probabilities(pdf, (h, w)))
    parts = dict(means=means[None].astype(np.float32), covariances=np.tile(np.eye(3, dtype=np.float32), (1, n, 1, 1)),
                 harmonics=rng.rand(1, n, 3, 4).astype(np.float32), opacities=rng.rand(1, n).astype(np.float32),
                 scales=rng.rand(1, n, 3).astype(np.float32), rotations=rng.rand(1, n, 4).astype(np.float32))
    tg = TGaussians(**{k: torch.tensor(x) for k, x in parts.items()})
    jg = JGaussians(**parts)
    assert tev.gaussian_statistics(tg) == jev.gaussian_statistics(jg)
    np.testing.assert_array_equal(tev.visualize_gaussians(tg, (h, w), v, spp), jev.visualize_gaussians(jg, (h, w), v, spp))
