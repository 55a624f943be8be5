"""The port's NeRF/BARF lineage (models/nerf.py, training/barf_trainer.py)
against the JAX package's on the CPU: the positional encoding and BARF's
annealing weights, NeRFMLP with annealing weights (their layout over the
encoding kept as the JAX package has it), render_nerf_rays with injected
draws, the name maps, and BARFTrainer against JAX's over 3 train steps and
3 test-time pose steps from the same (converted) weights, with JAX's own
draws.

Inputs are made with numpy from a seed. The module fixture runs every JAX
computation once, jitted (the trainer jits its own steps). Each test
states its tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrt_official_torch import weights
from ggrt_official_torch.models import nerf as tnerf
from ggrt_official_torch.training import barf_trainer as tbarf
from ggrt_official_tpu.geometry.se3 import se3_exp as jse3_exp
from ggrt_official_tpu.models import nerf as jnerf
from ggrt_official_tpu.training import barf_trainer as jbarf
from tests.test_torch_train import import_beside_placeholders  # noqa: F401  (torch.optim's first import)

CFG = dict(num_cameras=2, depth=6, width=32, num_freqs_xyz=4, n_samples=16, near=1.0, far=4.0, lr=3e-3,
           lr_pose=3e-3)
N_RAYS, N_ITERS, STEPS = 128, 10, (2, 3, 4)   # progress 0.25, 0.5, 0.75: bands half open


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.tensor(np.asarray(x))


def close(actual, expected, **tol):
    np.testing.assert_allclose(np.asarray(actual.detach() if isinstance(actual, torch.Tensor) else actual,
                                          np.float64),
                               np.asarray(expected, np.float64), **tol)


def make_batch(seed=1, n=N_RAYS):
    """Camera-local rays and the colour where each hits the z = 2.5 plane (the
    JAX package's test scene), seen from camera 1 with a base pose off the
    identity, as numpy."""
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(n, 3)) * [0.3, 0.3, 0.0] + [0.0, 0.0, 1.0]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hit = 2.5 / d[:, 2:3] * d
    rgb = 0.5 + 0.4 * np.stack([np.sin(2 * hit[:, 0]), np.sin(2 * hit[:, 1]), np.cos(1.5 * hit[:, 0] + 1.5 * hit[:, 1])], -1)
    base = np.asarray(jse3_exp(jnp.array([0.02, -0.03, 0.01, 0.05, 0.0, -0.02])))
    return {"rays_o": np.zeros((n, 3), np.float32), "rays_d": d.astype(np.float32),
            "rgb": np.clip(rgb, 0, 1).astype(np.float32), "cam_idx": np.array(1, np.int32),
            "base_c2w": base.astype(np.float32)}


@pytest.fixture(scope="module")
def jx():
    out = {}
    rng = np.random.RandomState(0)
    out["x"] = rng.uniform(-1, 1, (7, 3)).astype(np.float32)
    out["pe"] = np.asarray(jax.jit(jnerf.positional_encoding, static_argnums=1)(out["x"], 5))
    out["anneal"] = {p: np.asarray(jax.jit(jnerf.barf_annealing_weights, static_argnums=0)(4, jnp.float32(p)))
                     for p in (0.0, 0.3, 0.55, 1.0)}

    mlp = jnerf.NeRFMLP(depth=6, width=32, num_freqs_xyz=3, num_freqs_dir=2)
    xyz, dirs = rng.normal(size=(2, 5, 3)).astype(np.float32), rng.normal(size=(2, 5, 3)).astype(np.float32)
    w = np.array([1.0, 0.6, 0.1], np.float32)
    params = mlp.init(jax.random.PRNGKey(1), xyz, dirs, w)
    out["mlp"] = (params, xyz, dirs, w, np.asarray(jax.jit(mlp.apply)(params, xyz, dirs, w)))

    # render_nerf_rays on a BARFModel, jittered by a key's draws.
    model = jnerf.BARFModel(num_cameras=2, depth=3, width=16, num_freqs_xyz=3)
    ro = rng.normal(size=(9, 3)).astype(np.float32) * 0.1
    rd = (rng.normal(size=(9, 3)) * [0.3, 0.3, 0.1] + [0, 0, 1]).astype(np.float32)
    bparams = model.init(jax.random.PRNGKey(2), ro[:, None], rd[:, None])
    key = jax.random.PRNGKey(3)
    render = jax.jit(lambda p, k: jnerf.render_nerf_rays(lambda a, b: model.apply(p, a, b, 0.5), ro, rd, 1.0, 4.0, 12, k))
    out["render"] = (bparams, ro, rd, np.asarray(jax.random.uniform(key, (9, 12))),
                     jax.tree_util.tree_map(np.asarray, render(bparams, key)),
                     jax.tree_util.tree_map(np.asarray, jax.jit(
                         lambda p: jnerf.render_nerf_rays(lambda a, b: model.apply(p, a, b, 0.5), ro, rd, 1.0, 4.0, 12))(bparams)))

    # The trainer: 3 joint steps, then 3 test-time pose steps.
    tr = jbarf.BARFTrainer(jbarf.BARFTrainConfig(**CFG), rng=jax.random.PRNGKey(0))
    batch = make_batch()
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    tr.init(jbatch["rays_o"], jbatch["rays_d"])
    init_params = jax.tree_util.tree_map(np.asarray, tr.params)
    draws, losses = [], []
    for s in STEPS:
        _, k = jax.random.split(tr.rng)
        draws.append(np.asarray(jax.random.uniform(k, (N_RAYS, CFG["n_samples"]))))
        losses.append(tr.train_step(jbatch, s, N_ITERS))
    test = make_batch(seed=2)
    bad = np.asarray(jse3_exp(jnp.array([0.04, -0.03, 0.03, 0.0, 0.0, 0.0]))).astype(np.float32)
    c2w, pose_losses = tr.optimize_test_pose(jnp.asarray(test["rays_o"]), jnp.asarray(test["rays_d"]),
                                             jnp.asarray(test["rgb"]), jnp.asarray(bad), n_steps=3)
    out["trainer"] = dict(init=init_params, batch=batch, draws=draws, losses=losses,
                          params=jax.tree_util.tree_map(np.asarray, tr.params), test=test, bad=bad,
                          c2w=np.asarray(c2w), pose_losses=pose_losses, progress=[tr.progress(s, N_ITERS) for s in STEPS])
    return out


def test_positional_encoding(jx):
    """(7, 3) -> (7, 30) in (d, L, sin/cos) order: rtol 1e-6, atol 2e-6
    (sin and cos of angles up to 16π)."""
    close(tnerf.positional_encoding(t(jx["x"]), 5), jx["pe"], rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("progress", [0.0, 0.3, 0.55, 1.0])
def test_annealing_weights(jx, progress):
    """BARF's cosine ramp of 4 bands at a float32 progress: atol 1e-6."""
    close(tnerf.barf_annealing_weights(4, progress), jx["anneal"][progress], rtol=0, atol=1e-6)


def test_nerf_mlp_with_pe_weights(jx):
    """NeRFMLP (depth 6, the skip after layer 4) with annealing weights over
    3 bands: rgb+sigma rtol 1e-5, atol 1e-6. The weights reach the encoding
    as repeat(repeat(w, 2), 3): entry j of the (3, L, 2) encoding takes
    w[j // 6], which differs from each band's own weight at L >= 2."""
    params, xyz, dirs, w, want = jx["mlp"]
    mlp = tnerf.NeRFMLP(depth=6, width=32, num_freqs_xyz=3, num_freqs_dir=2)
    mlp.load_state_dict(weights.nerf_params_from_jax(jax.tree_util.tree_map(np.asarray, params), depth=6))
    got = mlp(t(xyz), t(dirs), t(w))
    close(got, want, rtol=1e-5, atol=1e-6)
    # The layout, spelled out: coordinate 0's bands take w0, w0, w0; coordinate 2's w2.
    enc_w = torch.repeat_interleave(torch.repeat_interleave(t(w), 2), 3).reshape(3, 3, 2)
    assert enc_w[0, :, 0].tolist() == [1.0, 1.0, 1.0] and enc_w[2, :, 0].tolist() == pytest.approx([0.1] * 3)
    assert not torch.equal(enc_w[:, :, 0], t(w).expand(3, 3))


@pytest.mark.parametrize("jitter", [True, False])
def test_render_nerf_rays(jx, jitter):
    """A BARFModel at progress 0.5 rendered along 12 samples from near 1 to
    far 4, jittered by JAX's draws or on the linspace: rgb, depth and
    weights rtol 1e-5, atol 1e-5."""
    params, ro, rd, u, want_jit, want_det = jx["render"]
    model = tnerf.BARFModel(num_cameras=2, depth=3, width=16, num_freqs_xyz=3)
    model.load_state_dict(weights.barf_params_from_jax(jax.tree_util.tree_map(np.asarray, params), depth=3))
    got = tnerf.render_nerf_rays(lambda a, b: model(a, b, 0.5), t(ro), t(rd), 1.0, 4.0, 12,
                                 t(u) if jitter else None)
    want = want_jit if jitter else want_det
    for k in ("rgb", "depth", "weights"):
        close(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_linspace_is_jax():
    """The renderer's linspace (constants.linspace) is jnp.linspace's float32
    arithmetic, start·(1 - t) + stop·t at t = i/(n-1): within two float32
    spacings of max(|start|, |stop|) of it (XLA may take t as i·(1/(n-1))
    and fuse the sum into an FMA); both ends exact, and [start] at n = 1."""
    cases = [(1.0, 4.0, n) for n in (1, 2, 7, 64, 1000)] + [(0.0, 1.0, n) for n in (1, 2, 7, 64, 1000)]
    for a, b, n in cases + [(1.0, 4.0, 16), (-6.0, 0.0, 65536), (1e-4, 1.0, 1024), (2.0, 6.0, 64)]:
        got, want = tnerf.linspace(a, b, n).numpy(), np.asarray(jnp.linspace(a, b, n))
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.spacing(np.float32(max(abs(a), abs(b)))))
        assert (got[0], got[-1]) == (want[0], want[-1])


def test_render_nerf_rays_one_sample_at_near(jx):
    """n_samples = 1: the one sample sits at `near`, as jnp.linspace(near,
    far, 1) = [near] puts it (not at `far`); rgb, depth and weights against
    JAX's at rtol 1e-5, atol 1e-5."""
    params, ro, rd = jx["render"][:3]
    jmodel = jnerf.BARFModel(num_cameras=2, depth=3, width=16, num_freqs_xyz=3)
    want = jax.jit(lambda p: jnerf.render_nerf_rays(lambda a, b: jmodel.apply(p, a, b, 0.5), ro, rd,
                                                     1.0, 4.0, 1))(params)
    model = tnerf.BARFModel(num_cameras=2, depth=3, width=16, num_freqs_xyz=3)
    model.load_state_dict(weights.barf_params_from_jax(jax.tree_util.tree_map(np.asarray, params), depth=3))
    seen = []

    def apply(a, b):
        seen.append(a)
        return model(a, b, 0.5)

    got = tnerf.render_nerf_rays(apply, t(ro), t(rd), 1.0, 4.0, 1)
    close(seen[0], (ro + rd)[:, None], rtol=0, atol=1e-7)
    for k in ("rgb", "depth", "weights"):
        close(got[k], want[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["nerf", "barf"])
def test_name_maps_cover_both_trees(jx, which):
    """Every flax leaf and every port key is one row, shapes convertible."""
    if which == "nerf":
        tree, rows, port = jx["mlp"][0]["params"], weights.nerf_mlp_name_map(6), tnerf.NeRFMLP(6, 32, 3, 2)
    else:
        tree, rows = jx["trainer"]["init"]["params"], weights.barf_name_map(CFG["depth"])
        port = tnerf.BARFModel(CFG["num_cameras"], CFG["depth"], CFG["width"], CFG["num_freqs_xyz"])
    flax_leaves = {tuple(k.key for k in path): leaf.shape for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    port_keys = {k: v.shape for k, v in port.state_dict().items()}
    assert {k for k, _, _ in rows} == set(port_keys)
    assert {p for _, p, _ in rows} == set(flax_leaves)
    assert len(rows) == len(port_keys) == len(flax_leaves)
    for key, path, kind in rows:
        assert weights._from_flax(kind, np.zeros(flax_leaves[path], np.float32)).shape == tuple(port_keys[key]), key


@pytest.fixture(scope="module")
def port_trainer(jx):
    """The port's trainer from the JAX trainer's initial weights, through the
    same 3 steps at JAX's draws, then the same 3 test-time pose steps."""
    c = jx["trainer"]
    tr = tbarf.BARFTrainer(tbarf.BARFTrainConfig(**CFG), device="cpu")
    tr.init()
    tr.model.load_state_dict(weights.barf_params_from_jax(c["init"], CFG["depth"]))
    batch = {k: t(v) for k, v in c["batch"].items()}
    losses = [tr.train_step(batch, s, N_ITERS, uniforms=t(u)) for s, u in zip(STEPS, c["draws"])]
    test = c["test"]
    c2w, pose_losses = tr.optimize_test_pose(t(test["rays_o"]), t(test["rays_d"]), t(test["rgb"]), t(c["bad"]),
                                             n_steps=3)
    return dict(tr=tr, losses=losses, c2w=c2w, pose_losses=pose_losses)


def test_trainer_progress_matches_jax(jx):
    """The annealing schedule: equal floats at every step of 20."""
    cfg = tbarf.BARFTrainConfig(**CFG)
    want = jbarf.BARFTrainer(jbarf.BARFTrainConfig(**CFG))
    port = tbarf.BARFTrainer(cfg, device="cpu")
    assert [port.progress(s, 20) for s in range(21)] == [want.progress(s, 20) for s in range(21)]
    assert jx["trainer"]["progress"] == pytest.approx([0.25, 0.5, 0.75])


def test_train_steps_match_jax(jx, port_trainer):
    """Three joint steps from the same weights at JAX's draws: each loss
    rtol 1e-5; every parameter after the steps rtol 1e-4, atol 2e-5 (Adam's
    first steps move each weight by ~lr = 3e-3 whatever its gradient's
    size, so a gradient that is float noise in both could move a weight
    either way; none does here). pose_refine of camera 1 moves, camera 0's
    does not (its rows get zero gradients, and Adam moves 0/(0 + eps) = 0)."""
    c, p = jx["trainer"], port_trainer
    assert all(isinstance(x, torch.Tensor) and x.dim() == 0 for x in p["losses"])
    close([float(x) for x in p["losses"]], c["losses"], rtol=1e-5)
    want = weights.barf_params_from_jax(c["params"], CFG["depth"])
    got = p["tr"].model.state_dict()
    for k, v in want.items():
        close(got[k], v, rtol=1e-4, atol=2e-5, err_msg=k)
    pose = got["pose_refine"]
    assert float(pose[1].abs().max()) > 1e-3 and float(pose[0].abs().max()) == 0.0
    init = weights.barf_params_from_jax(c["init"], CFG["depth"])
    assert float((got["nerf.fc0.weight"] - init["nerf.fc0.weight"]).abs().max()) > 1e-3


def test_test_pose_steps_match_jax(jx, port_trainer):
    """Three test-time pose steps (field frozen, Adam at lr_pose on one
    se(3) delta): the losses rtol 1e-5, the corrected c2w atol 1e-5; the
    field's weights are left as they were."""
    c, p = jx["trainer"], port_trainer
    assert isinstance(p["pose_losses"], list) and len(p["pose_losses"]) == 3
    close(p["pose_losses"], c["pose_losses"], rtol=1e-5)
    close(p["c2w"], c["c2w"], rtol=0, atol=1e-5)
    assert not np.allclose(p["c2w"].numpy(), c["bad"])
    close(p["tr"].model.state_dict()["nerf.fc0.weight"],
          weights.barf_params_from_jax(c["params"], CFG["depth"])["nerf.fc0.weight"], rtol=1e-4, atol=2e-5)


def test_train_step_draws_from_its_generator():
    """Without uniforms the step draws from the trainer's generator: two
    trainers with one seed take equal steps, another seed another."""
    batch = {k: t(v) for k, v in make_batch().items()}
    losses = []
    for seed in (0, 0, 1):
        tr = tbarf.BARFTrainer(tbarf.BARFTrainConfig(**CFG), device="cpu", seed=seed)
        tr.init()
        tr.train_step(batch, 2, N_ITERS)
        losses.append(float(tr.train_step(batch, 3, N_ITERS)))
    assert losses[0] == losses[1] != losses[2]


def test_config_fields_are_jax():
    """BARFTrainConfig has the JAX package's fields and defaults."""
    assert [(f.name, f.default) for f in dataclasses.fields(tbarf.BARFTrainConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jbarf.BARFTrainConfig)]
