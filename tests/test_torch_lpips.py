"""The port's LPIPS network (ggrt_official_torch/evaluation/lpips.py) against
the JAX package's LPIPSJax on the CPU, with random weights made as
torchvision's and the lpips package's state dicts and carried both ways:
through JAX's convert_torch_state_dicts and the port's flax carrier, and
through the .npz that JAX's save_weights writes. Then metrics.lpips with
$GGRT_LPIPS_WEIGHTS set (the evaluator's lpips key: test_torch_eval.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrt_official_torch.evaluation import lpips as tlpips
from ggrt_official_torch.evaluation import metrics as tmetrics
from ggrt_official_tpu.evaluation import lpips_jax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def torch_state_dicts(seed):
    """Random (torchvision alexnet, lpips) state dicts as numpy arrays: the
    classifier and the lpips package's own trunk and scaling entries too,
    which a load must leave aside; lin weights of both signs, so that the
    non-negative clamp matters."""
    rng = np.random.RandomState(seed)
    alex, c_in = {}, 3
    for idx, (c, k, _, _) in zip(tlpips.FEATURE_INDEX, [s for s in tlpips.ALEX if s]):
        alex[f"features.{idx}.weight"] = (rng.normal(size=(c, c_in, k, k)) / np.sqrt(c_in * k * k)).astype(np.float32)
        alex[f"features.{idx}.bias"] = (0.1 * rng.normal(size=c)).astype(np.float32)
        c_in = c
    alex["classifier.1.weight"] = rng.normal(size=(8, 9)).astype(np.float32)
    lp = {f"lin{i}.model.1.weight": (0.1 * rng.normal(size=(1, c, 1, 1))).astype(np.float32)
          for i, c in enumerate(tlpips.TAP_CHANNELS)}
    lp["net.slice1.0.weight"] = alex["features.0.weight"]
    lp["scaling_layer.shift"] = np.zeros((1, 3, 1, 1), np.float32)
    return alex, lp


def images(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, size=shape).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def lpips_case():
    """JAX's distances of two image pairs (2 of 64x64, 1 of 80x96) under the
    converted random weights, from one jitted apply per shape."""
    alex, lp = torch_state_dicts(0)
    params = lpips_jax.convert_torch_state_dicts(alex, lp)
    model = lpips_jax.LPIPSJax()
    run = jax.jit(lambda p, a, b: model.apply({"params": p}, a, b))
    ins = {shape: images(i, shape) for i, shape in enumerate([(2, 3, 64, 64), (1, 3, 80, 96)])}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    out = {shape: np.asarray(run(params, *ab)) for shape, ab in ins.items()}
    return dict(alex=alex, lp=lp, params=params, ins=ins, out=out, run=run)


@pytest.mark.parametrize("carrier", ["state_dicts", "flax_tree", "npz"])
def test_lpips_matches_jax(lpips_case, carrier, tmp_path):
    """The port's distances against LPIPSJax's, rtol 1e-4 atol 1e-6 (float32
    convolutions in another order), with the weights loaded from the torch
    state dicts as they are, from JAX's flax tree, or from JAX's .npz."""
    c = lpips_case
    model = tlpips.LPIPS()
    if carrier == "state_dicts":
        tlpips.load_state_dicts(model, c["alex"], c["lp"])
    elif carrier == "flax_tree":
        model.load_state_dict(tlpips.state_dict_from_flax(c["params"]))
    else:
        path = str(tmp_path / "lpips_alex.npz")
        lpips_jax.save_weights(path, c["alex"], c["lp"])
        tlpips.load_npz(model, path)
    assert torch.equal(model.features[0].weight, torch.tensor(c["alex"]["features.0.weight"]))
    with torch.no_grad():
        for shape, (a, b) in c["ins"].items():
            got = model(torch.tensor(a), torch.tensor(b)).numpy()
            assert got.shape == (shape[0],)
            np.testing.assert_allclose(got, c["out"][shape], rtol=1e-4, atol=1e-6)


def test_state_dict_names_are_the_packages():
    """The module's entries are exactly torchvision's `features` convolutions
    and the lpips package's lin heads, so their state dicts load as they are."""
    want = {f"features.{i}.{p}" for i in tlpips.FEATURE_INDEX for p in ("weight", "bias")}
    want |= {f"lin{i}.model.1.weight" for i in range(5)}
    assert set(tlpips.LPIPS().state_dict()) == want


def test_metric_with_weights(lpips_case, tmp_path, monkeypatch):
    """metrics.lpips with $GGRT_LPIPS_WEIGHTS naming JAX's .npz: the port's
    network on the images' device against LPIPSJax on the same weights, as
    JAX's lpips_fn applies it to [0, 1] images (x·2 - 1), rtol 1e-4 atol
    1e-6; for tensors and arrays alike; 0 for an image against itself."""
    c = lpips_case
    path = str(tmp_path / "lpips_alex.npz")
    lpips_jax.save_weights(path, c["alex"], c["lp"])
    monkeypatch.setenv("GGRT_LPIPS_WEIGHTS", path)
    rng = np.random.RandomState(2)
    x = rng.uniform(size=(3, 80, 96)).astype(np.float32)
    y = np.clip(x + 0.2 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    want = float(c["run"](c["params"], x[None] * 2 - 1, y[None] * 2 - 1)[0])
    got_np, got_t = tmetrics.lpips(x, y), tmetrics.lpips(torch.tensor(x), torch.tensor(y))
    assert isinstance(got_np, float) and isinstance(got_t, float)
    np.testing.assert_allclose([got_np, got_t], [want, want], rtol=1e-4, atol=1e-6)
    assert abs(tmetrics.lpips(x, x)) < 1e-6 < got_np


def test_save_weights_is_jax_format(lpips_case, tmp_path):
    """The port's save_weights writes the npz of JAX's save_weights: the same
    tree, the same arrays (exact)."""
    c = lpips_case
    tlpips.save_weights(str(tmp_path / "t.npz"), c["alex"], c["lp"])
    lpips_jax.save_weights(str(tmp_path / "j.npz"), c["alex"], c["lp"])
    with np.load(tmp_path / "t.npz", allow_pickle=True) as a, np.load(tmp_path / "j.npz", allow_pickle=True) as b:
        got, want = a["params"].item(), b["params"].item()
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys() and len(want) == 15
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
