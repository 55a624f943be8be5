"""Pretrained trunks and the IPO-Net encoder's norm kinds, the port against
the JAX package on the CPU.

The weights come from the torchvision-compatible stub ResNets of
tests/reference_stubs.py, as tests/test_pretrained.py takes them: no
pretrained weights exist offline. The converters must give JAX's trees
exactly; an .npz either package writes must load into the port's modules
and give the JAX module's outputs (relative L2 1e-5, float32 convolutions
summed in another order); ResNetEncoder with instance and group norm must
give JAX's outputs on JAX's weights to the same tolerance.
"""
import warnings

import numpy as np
import pytest

from tests import reference_stubs

reference_stubs.install()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ggrt_official_torch import weights  # noqa: E402
from ggrt_official_torch.config import apply_overrides, tiny_config  # noqa: E402
from ggrt_official_torch.models import backbone as tbb  # noqa: E402
from ggrt_official_torch.training import pretrained as tpre  # noqa: E402
from ggrt_official_torch.training.trainer import GGRtTrainer  # noqa: E402
from ggrt_official_tpu.models import backbone as jbb  # noqa: E402
from ggrt_official_tpu.training import pretrained as jpre  # noqa: E402
from tests.test_torch_train import import_beside_placeholders  # noqa: E402,F401  (torch.optim's first import)

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def stub_state(fn, seed):
    torch.manual_seed(seed)
    return {k: v.detach().numpy() for k, v in fn().state_dict().items()}


def trees_equal(a, b, path=""):
    assert a.keys() == b.keys(), path
    for k in a:
        if isinstance(a[k], dict):
            trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")


@pytest.fixture(scope="module")
def resnet50_sd():
    return stub_state(reference_stubs.resnet50, 0)


@pytest.fixture(scope="module")
def resnet18_sd():
    return stub_state(reference_stubs.resnet18, 1)


def test_backbone_converter_matches_jax(resnet50_sd):
    trees_equal(tpre.convert_torchvision_resnet_for_backbone(resnet50_sd, "resnet50", num_layers=3),
                jpre.convert_torchvision_resnet_for_backbone(resnet50_sd, "resnet50", num_layers=3))


@pytest.mark.parametrize("n_images", [1, 2])
def test_ipo_converter_matches_jax(resnet18_sd, n_images):
    got = tpre.convert_imagenet_resnet_for_ipo(resnet18_sd, num_input_images=n_images)
    trees_equal(got, jpre.convert_imagenet_resnet_for_ipo(resnet18_sd, num_input_images=n_images))
    assert got["conv1"]["kernel"].shape == (7, 7, 3 * n_images, 64)


@pytest.fixture(scope="module")
def jax_backbone(resnet50_sd, tmp_path_factory):
    """JAX's BackboneResnet (resnet50, 3 layers, d_out 16) with the stub's
    trunk merged from the .npz JAX's converter wrote: (npz path, params,
    input, output)."""
    path = str(tmp_path_factory.mktemp("pre") / "resnet50.npz")
    jpre.save_pretrained_npz(path, jpre.convert_torchvision_resnet_for_backbone(resnet50_sd, "resnet50", 3))
    fm = jbb.BackboneResnet(model="resnet50", num_layers=3, d_out=16)
    x = np.random.RandomState(0).rand(1, 2, 8, 12, 3).astype(np.float32)
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params, loaded = jpre.maybe_load_backbone({"backbone": variables["params"]}, path, ("backbone",))
    assert loaded
    out = fm.apply({"params": params["backbone"]}, jnp.asarray(x))
    return path, params["backbone"], x, np.asarray(out)


def test_jax_npz_loads_into_the_port(jax_backbone):
    path, params, x, want = jax_backbone
    m = tbb.BackboneResnet("resnet50", 3, 16)
    # The 1x1 projections are not in the file: take JAX's, then the trunk
    # from the file alone.
    proj = [r for r in weights.backbone_resnet_name_map("resnet50", 3) if r[0].startswith("projections.")]
    m.load_state_dict(weights._convert(params, proj, ""), strict=False)
    before = m(torch.tensor(x)).detach().numpy()
    assert tpre.maybe_load_backbone(m, path, weights.backbone_resnet_name_map("resnet50", 3))
    got = m(torch.tensor(x)).detach().numpy()
    assert rel(got, want) < RTOL and rel(before, want) > 0.1


def test_port_npz_loads_in_jax(resnet18_sd, tmp_path):
    path = str(tmp_path / "ipo.npz")
    tpre.save_pretrained_npz(path, tpre.convert_imagenet_resnet_for_ipo(resnet18_sd))
    trees_equal(jpre.load_pretrained_npz(path), jpre.convert_imagenet_resnet_for_ipo(resnet18_sd))


def test_missing_file_warns_and_leaves_the_module(tmp_path):
    m = tbb.BackboneResnet("resnet18", 3, 8)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    with pytest.warns(UserWarning, match="not found"):
        assert not tpre.maybe_load_backbone(m, str(tmp_path / "absent.npz"),
                                            weights.backbone_resnet_name_map("resnet18", 3))
    assert not tpre.maybe_load_backbone(m, None, [])
    assert all(torch.equal(v, before[k]) for k, v in m.state_dict().items())


def test_init_full_loads_the_trunks(resnet18_sd, tmp_path):
    """init_full with both pretrained paths: the backbone's trunk and
    IPO-Net's fnet and cnet_depth take the file's weights; cnet_pose's
    6-channel conv1 keeps its own (the 3-channel kernel does not fit), its
    other trunk weights load; a missing file warns and trains from
    scratch."""
    bb, ipo = str(tmp_path / "bb.npz"), str(tmp_path / "ipo.npz")
    tpre.save_pretrained_npz(bb, tpre.convert_torchvision_resnet_for_backbone(resnet18_sd, "resnet18", 3))
    tpre.save_pretrained_npz(ipo, tpre.convert_imagenet_resnet_for_ipo(resnet18_sd))
    cfg = apply_overrides(tiny_config(), {"encoder.backbone.pretrained_path": bb, "iponet.pretrained_path": ipo})
    trainer = GGRtTrainer(cfg, device="cpu")
    trainer.init_full()
    fresh = GGRtTrainer(tiny_config(), device="cpu")
    fresh.init_full()
    m, f = trainer.model, fresh.model
    w = torch.tensor(resnet18_sd["conv1.weight"])
    assert torch.equal(m.gaussian.encoder.backbone.model.conv1.weight, w)
    assert torch.equal(m.pose_learner.fnet.conv1.weight, w)
    assert torch.equal(m.pose_learner.cnet_depth.layer1[0].bn1.running_var,
                       torch.tensor(resnet18_sd["layer1.0.bn1.running_var"]))
    assert torch.equal(m.pose_learner.cnet_pose.conv1.weight, f.pose_learner.cnet_pose.conv1.weight)
    assert torch.equal(m.pose_learner.cnet_pose.layer2[0].conv1.weight,
                       torch.tensor(resnet18_sd["layer2.0.conv1.weight"]))
    assert torch.equal(m.pose_learner.fnet.out_conv.weight, f.pose_learner.fnet.out_conv.weight)

    missing = apply_overrides(tiny_config(), {"encoder.backbone.pretrained_path": str(tmp_path / "none.npz")})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        GGRtTrainer(missing, device="cpu").init_full()
    assert any("not found" in str(c.message) for c in caught)


@pytest.mark.parametrize("norm", ["instance", "group", "batch"])
@pytest.mark.parametrize("stride", [8])  # IPO-Net's feature ratio; the norms do not depend on it
def test_resnet_encoder_norms_match_jax(norm, stride):
    fm = jbb.ResNetEncoder(out_chs=16, stride=stride, norm=norm)
    x = np.random.RandomState(1).normal(size=(2, 32, 48, 6)).astype(np.float32)
    params = fm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    if norm != "instance":
        # Non-trivial affine (and running) parameters, the same in both.
        rs = np.random.RandomState(2)
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: (np.asarray(v) + 0.1 * rs.normal(size=v.shape).astype(np.float32))
            if p[-1].key in ("scale", "bias", "mean") else
            (np.asarray(v) * rs.uniform(0.5, 1.5, v.shape).astype(np.float32) if p[-1].key == "var" else v),
            params)
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    m = tbb.ResNetEncoder(6, 16, stride, norm=norm)
    rows = weights.resnet_encoder_name_map("resnet18", stride=stride, norm=norm)
    state = weights._convert(jax.tree_util.tree_map(np.asarray, params), rows, "")
    missing, unexpected = m.load_state_dict(state, strict=False)
    assert not unexpected and not [k for k in missing if not k.endswith(("running_mean", "running_var"))
                                   or norm == "batch"]
    got = m(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape and rel(got, want) < RTOL, rel(got, want)
    if norm == "group":
        assert m.bn1.eps == 1e-6 and m.bn1.num_groups == 8
