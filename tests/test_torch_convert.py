"""The port's reference-checkpoint converter (training/convert.py) against
the JAX package's, on the CPU.

A reference-shaped checkpoint ({'pose_learner': ..., 'gaussian':
{'encoder.*': ...}}, numpy) is built from a port GGRtModel's own
state_dict at __graft_entry__._tiny_cfg() widths with the epipolar
transformer on, so the ConvTranspose rows (the image self-attention's
resampler, the transformer's upscaler), which JAX flips spatially and
weights._from_flax flips back, are in it. Conversions are exact: every
comparison is bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ggrt_official_tpu.data import datasets as jds
from ggrt_official_tpu.models.ggrt import GGRtModel as JModel
from ggrt_official_tpu.training import convert as jconvert
from ggrt_official_tpu.training.trainer import GGRtTrainer as JTrainer
from ggrt_official_torch import config, weights
from ggrt_official_torch.models.ggrt import GGRtModel
from ggrt_official_torch.training import convert
from tests.test_torch_models import port_cfg


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def checkpoint_of(sd: dict) -> dict:
    """The reference's composite keying of a GGRtModel state_dict, numpy."""
    return {part: {k.removeprefix(part + "."): v.numpy() for k, v in sd.items() if k.startswith(part + ".")}
            for part in ("pose_learner", "gaussian")}


def jax_tree_of(sd: dict, cfg) -> dict:
    """The flax tree of a port state_dict, written by JAX's own converter."""
    ck = checkpoint_of(sd)
    enc = {k.removeprefix("encoder."): v for k, v in ck["gaussian"].items()}
    return {"pose_learner": jconvert.apply_name_map(ck["pose_learner"], jconvert.depth_pose_net_name_map()),
            "gaussian": {"encoder": jconvert.apply_name_map(enc, jconvert.encoder_name_map(cfg.encoder))}}


@pytest.fixture(scope="module")
def case():
    """_tiny_cfg() (epipolar transformer on); the JAX model's parameter
    shapes by jax.eval_shape of its two inits; port models from seeds 0
    (the checkpoint's) and 1 (the template)."""
    jcfg = graft._tiny_cfg()
    assert jcfg.encoder.use_epipolar_transformer
    pcfg = port_cfg(jcfg)
    ds = jds.SyntheticPlanesDataset(jds.SyntheticSceneSpec(n_views=8, image_size=(32, 64)), num_source_views=3)
    jb = JTrainer(jcfg).prepare_batch(jds.collate_batch(ds[0]))
    model = JModel(jcfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    pose = jax.eval_shape(lambda b: model.init(
        {"params": k1}, b["rgb"], b["src_rgbs"], b["camera"], b["src_cameras"],
        b["depth_range"][0, 0], b["depth_range"][0, 1], compute_sfm_loss=False, method="iponet"), jb)
    gauss = jax.eval_shape(lambda b: model.init({"params": k1, "sample": k2}, b, 0, deterministic=True,
                                                method="gaussian_forward"), jb)
    shapes = {"pose_learner": pose["params"]["pose_learner"], "gaussian": gauss["params"]["gaussian"]}
    src = GGRtModel(pcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return dict(jcfg=jcfg, pcfg=pcfg, shapes=shapes, sd=src.state_dict())


def template_model(case):
    return GGRtModel(case["pcfg"], device="cpu", generator=torch.Generator().manual_seed(1))


def assert_equal_sd(actual: dict, expected: dict):
    assert sorted(actual) == sorted(expected)
    for k in expected:
        assert torch.equal(torch.as_tensor(actual[k]), expected[k]), k


def test_checkpoint_round_trips_through_jax_bit_for_bit(case):
    """JAX's convert_reference_checkpoint (into the JAX model's own
    parameter tree) then weights.ggrt_params_from_jax gives back every
    tensor of the checkpoint; every leaf of JAX's tree is converted."""
    kinds = {kind for _, _, kind in weights.encoder_name_map(case["pcfg"].encoder)}
    assert "conv_transpose" in kinds
    tree = jconvert.convert_reference_checkpoint(checkpoint_of(case["sd"]), case["shapes"],
                                                 encoder_cfg=case["jcfg"].encoder)
    leaves = jax.tree_util.tree_leaves(tree)
    assert all(isinstance(x, np.ndarray) for x in leaves), "a leaf of the JAX model is not converted"
    assert_equal_sd(weights.ggrt_params_from_jax(tree, case["pcfg"]), case["sd"])


def test_port_converter_equals_jax(case):
    """The port's converter, into a seed-1 model, gives the JAX converter's
    state_dict, and loading it makes the model the checkpoint's."""
    tree = jconvert.convert_reference_checkpoint(checkpoint_of(case["sd"]), case["shapes"],
                                                 encoder_cfg=case["jcfg"].encoder)
    model = template_model(case)
    out = convert.convert_reference_checkpoint(checkpoint_of(case["sd"]), model, encoder_cfg=case["pcfg"].encoder)
    assert_equal_sd(out, {k: torch.as_tensor(v) for k, v in weights.ggrt_params_from_jax(tree, case["pcfg"]).items()})
    model.load_state_dict(out)
    assert_equal_sd(model.state_dict(), case["sd"])


@pytest.mark.parametrize("part,key", [("pose_learner", "update_block_pose.pose_gru.convq2.bias"),
                                      ("gaussian", "encoder.epipolar_transformer.upscaler.weight")])
def test_missing_row_raises_key_error(case, part, key):
    ck = checkpoint_of(case["sd"])
    del ck[part][key]
    with pytest.raises(KeyError, match="missing torch key"):
        jconvert.convert_reference_checkpoint(ck, case["shapes"], encoder_cfg=case["jcfg"].encoder)
    with pytest.raises(KeyError, match="missing torch key"):
        convert.convert_reference_checkpoint(ck, template_model(case), encoder_cfg=case["pcfg"].encoder)


def test_wrong_shape_fails(case):
    """A present entry of another shape fails the shape check in both."""
    ck = checkpoint_of(case["sd"])
    key = "encoder.epipolar_transformer.transformer.layers.0.1.fn.self_attention.resampler.weight"
    ck["gaussian"][key] = np.zeros((1, *ck["gaussian"][key].shape[1:]), np.float32)
    with pytest.raises(AssertionError, match="shape mismatch"):
        jconvert.convert_reference_checkpoint(ck, case["shapes"], encoder_cfg=case["jcfg"].encoder)
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.convert_reference_checkpoint(ck, template_model(case), encoder_cfg=case["pcfg"].encoder)


@pytest.mark.parametrize("present", ["pose_learner", "gaussian"])
def test_partial_checkpoint_keeps_template(case, present):
    """strict=False: the entries a checkpoint does not name keep the
    template's values, in both packages (JAX's template is the seed-1
    model's flax tree)."""
    model = template_model(case)
    template = {k: v.clone() for k, v in model.state_dict().items()}
    ck = {present: checkpoint_of(case["sd"])[present]}
    out = convert.convert_reference_checkpoint(ck, model, encoder_cfg=case["pcfg"].encoder)
    jout = jconvert.convert_reference_checkpoint(ck, jax_tree_of(template, case["jcfg"]),
                                                 encoder_cfg=case["jcfg"].encoder)
    assert_equal_sd(out, {k: torch.as_tensor(v) for k, v in weights.ggrt_params_from_jax(jout, case["pcfg"]).items()})
    for k, v in out.items():
        assert torch.equal(v, (case["sd"] if k.startswith(present) else template)[k]), k


def test_encoder_cfg_none_maps_heads_and_five_projections(case):
    """encoder_cfg=None: the heads and backbone.projections.layer0-4 only.
    At _tiny_cfg()'s 3 backbone layers the checkpoint lacks layer3 and
    layer4, a KeyError in both; with them added (the template has no place
    for them, so they are dropped) both convert the rows they have."""
    ck = checkpoint_of(case["sd"])
    with pytest.raises(KeyError, match="layer3"):
        jconvert.convert_reference_checkpoint(ck, case["shapes"], encoder_cfg=None)
    with pytest.raises(KeyError, match="layer3"):
        convert.convert_reference_checkpoint(ck, template_model(case), encoder_cfg=None)
    for i in (3, 4):
        for name, shape in (("weight", (8, 8, 1, 1)), ("bias", (8,))):
            ck["gaussian"][f"encoder.backbone.projections.layer{i}.{name}"] = np.ones(shape, np.float32)
    model = template_model(case)
    template = {k: v.clone() for k, v in model.state_dict().items()}
    out = convert.convert_reference_checkpoint(ck, model, encoder_cfg=None)
    jout = jconvert.convert_reference_checkpoint(ck, jax_tree_of(template, case["jcfg"]), encoder_cfg=None)
    assert_equal_sd(out, {k: torch.as_tensor(v) for k, v in weights.ggrt_params_from_jax(jout, case["pcfg"]).items()})
    mapped = {"gaussian.encoder." + k for k, _, _ in weights.encoder_name_map(None)}
    assert len(weights.encoder_name_map(None)) == len(jconvert.encoder_name_map(None)) == 18
    for k, v in out.items():
        from_ckpt = k.startswith("pose_learner.") or k in mapped
        assert torch.equal(v, (case["sd"] if from_ckpt else template)[k]), k


@pytest.mark.parametrize("name", ["tiny_config", "dryrun_config", "pretrain_config"])
def test_rows_cover_every_state_dict_key(name):
    """The name maps cover every key of the port's GGRtModel.state_dict()
    and no other (the CPU's stand-in for the reference-parity cases that
    need the reference checkout)."""
    cfg = getattr(config, name)()
    sd = GGRtModel(cfg, device="cpu").state_dict()
    rows = (["pose_learner." + k for k, _, _ in weights.depth_pose_net_name_map(8)]
            + ["gaussian.encoder." + k for k, _, _ in weights.encoder_name_map(cfg.encoder)])
    assert len(rows) == len(set(rows))
    assert set(rows) == set(sd)


@pytest.mark.parametrize("kind,shape", [("dense", (5, 3)), ("conv", (4, 3, 3, 2)),
                                        ("conv_transpose", (4, 3, 2, 3)), ("bias", (4,)), ("raw", (2, 3))])
def test_layout_helpers_equal_jax(kind, shape):
    """convert_tensor gives JAX's flax layout, and weights._from_flax
    inverts it."""
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    out = convert.convert_tensor(kind, torch.tensor(w))
    np.testing.assert_array_equal(out, jconvert.convert_tensor(kind, w))
    assert out.flags.c_contiguous
    np.testing.assert_array_equal(weights._from_flax(kind, out), w)


def test_convert_tensor_rejects_unknown_kind():
    with pytest.raises(ValueError):
        convert.convert_tensor("batch_norm", np.zeros(3))
    with pytest.raises(ValueError):
        jconvert.convert_tensor("batch_norm", np.zeros(3))


def test_merge_params_strict_shapes():
    """A converted entry of another shape keeps the template's value, or
    raises with strict_shapes, as JAX's merge_params; entries the template
    lacks are dropped."""
    template = {"a": torch.zeros(2, 3), "b": torch.ones(4)}
    converted = {"a": torch.full((3, 2), 5.0), "b": torch.full((4,), 2.0), "c": torch.ones(1)}
    out = convert.merge_params(template, converted)
    assert sorted(out) == ["a", "b"] and torch.equal(out["a"], template["a"]) and torch.equal(out["b"], converted["b"])
    jout = jconvert.merge_params({k: v.numpy() for k, v in template.items()},
                                 {k: v.numpy() for k, v in converted.items()})
    for k in out:
        np.testing.assert_array_equal(out[k].numpy(), jout[k])
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.merge_params(template, converted, strict_shapes=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        jconvert.merge_params({k: v.numpy() for k, v in template.items()},
                              {k: v.numpy() for k, v in converted.items()}, strict_shapes=True)
