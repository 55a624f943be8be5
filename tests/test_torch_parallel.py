"""The port's parallel paths (parallel/*) on gloo, in ranks spawned by
`parallel.dryrun.spawn`, against the port's single-process paths and the
JAX package's shard_map on the 8 virtual CPU devices.

The spawned ranks import this module to find their functions, so it
imports JAX only inside the fixtures that use it: each rank then starts
with torch and the port alone. Each rank runs torch on one thread. Two
spawns serve the fast tests, one of 4 ranks (the mesh rules, tp 4
renders) and one of 2 (tp 2 renders, the dp 2 step), and one more the
dryrun. Tolerances: images atol 1e-5, rtol 1e-4 (tests/test_parallel.py's);
gradients within 1e-4 of the tensor's largest entry; the dp step's
gradients, aux and parameters bit for bit.
"""
import inspect
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ggrt_official_torch import config
from ggrt_official_torch.data import datasets as tds
from ggrt_official_torch.ops.rasterizer import api
from ggrt_official_torch.parallel import make_mesh
from ggrt_official_torch.parallel.dryrun import dryrun_multichip, spawn
from ggrt_official_torch.parallel.sharded_step import local_example, make_dp_train_step, replicate, shard_batch
from ggrt_official_torch.parallel.tile_parallel import render_tile_parallel
from ggrt_official_torch.training import state as tstate
from ggrt_official_torch.training.trainer import GGRtTrainer, make_pretrain_loss_fn

SHAPE = (24, 32)          # tests/test_rasterizer.py's: 3 tiles of 8x128, padded for tp 2 and 4
SCENE_ARGS = ("means", "covariances", "sh_coeffs", "opacities", "extrinsics", "intrinsics", "near", "far")
# test_parallel.py's two cases: the render (n 150, max_dup 32, K 256) and
# the gradient (n 50, K 64).
RENDER_KW = dict(max_dup=32, max_per_tile=256)
GRAD_KW = dict(max_per_tile=64)
BACKENDS = ("tiled", "cuda")
# The dp step's configuration: _dryrun_cfg() widths with the dataset's
# poses, the depth loss on and joint coefficient 0.5, as the port's other
# whole-step parity tests (untrained predicted poses make the epipolar
# triangulation ill-posed).
DP_OVERRIDES = {"train.use_pred_pose": False, "train.use_depth_loss": True, "train.joint_coefficient": 0.5}
SPAWN_TIMEOUT = 300.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the ranks; torch's lazily imported
    modules (an optimizer imports torch._dynamo) loaded beside the
    placeholder modules of tests/reference_stubs.py."""
    from tests.test_torch_train import import_beside_placeholders

    import_beside_placeholders("torch._dynamo")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_modules():
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from ggrt_official_tpu.parallel import mesh as jmesh
    from ggrt_official_tpu.parallel import tile_parallel as jtp
    from tests import test_rasterizer

    return SimpleNamespace(jax=jax, jnp=jnp, graft=graft, make_mesh=jmesh.make_mesh,
                           render_tile_parallel=jtp.render_tile_parallel, tr=test_rasterizer)


def dp_config(seed=None):
    """The dp step's configuration; `seed` (the weights') if given."""
    return config.apply_overrides(config.dryrun_config(), {**DP_OVERRIDES, **({} if seed is None else {"train.seed": seed})})


# --- the ranks' work ----------------------------------------------------------

def mesh_checks() -> dict:
    """make_mesh's rules at world 4: shapes, names, the first dp·tp ranks,
    and the errors."""
    out = {"axes": tuple(make_mesh(2, 2, "cpu").shape), "fill": tuple(make_mesh(tile_parallel=2, device_type="cpu").shape),
           "fill_tp1": tuple(make_mesh(device_type="cpu").shape)}
    sub = make_mesh(1, 2, "cpu")
    out["names"] = sub.mesh_dim_names
    out["subset"] = sub.get_coordinate()
    for name, args in (("tp3", (0, 3)), ("3x2", (3, 2))):
        try:
            make_mesh(*args, device_type="cpu")
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def render_all(scenes: dict, tp: int) -> dict:
    """Each scene with each backend, tiles over tp ranks: the image, and
    for the gradient scene d mean(img²) / d(means, background)."""
    mesh = make_mesh(1, tp, "cpu")
    out = {}
    for name, (scene, kw) in scenes.items():
        for backend in BACKENDS:
            grad = name == "grad"
            means = torch.tensor(scene["means"], requires_grad=grad)
            bg = torch.tensor(scene["background"], requires_grad=grad)
            rest = [torch.tensor(scene[k]) for k in SCENE_ARGS[1:]]
            with torch.set_grad_enabled(grad):
                img = render_tile_parallel(mesh, means, *rest, SHAPE, bg, backend=backend, **kw)
            res = {"img": img.detach().numpy()}
            if grad:
                gm, gb = torch.autograd.grad((img ** 2).mean(), (means, bg))
                res.update(means=gm.numpy(), background=gb.numpy())
            out[name, backend] = res
    return out


def dp_step(rank: int, state: dict, examples: list, uniforms: np.ndarray) -> dict:
    """One make_dp_train_step step at dp 2 (world 2). Rank 0 starts from
    `state`, rank 1 from its own seed, so replicate's broadcast shows.
    Returns the averaged gradients (before the clipped update), the aux
    and the parameters after."""
    cfg = dp_config(seed=rank + 7)
    trainer = GGRtTrainer(cfg, device="cpu")
    trainer.init_full()
    if rank == 0:
        trainer.model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    mesh = make_mesh(2, 1, "cpu")
    grads, apply = {}, trainer.state.apply_updates

    def capture(machine):
        grads.update({k: p.grad.numpy().copy() for k, p in trainer.model.named_parameters()})
        apply(machine)

    trainer.state.apply_updates = capture
    trainer.state.step = 1  # at step 0 the joint loss gives the Gaussian term no weight
    replicate(trainer.model, mesh)
    step = make_dp_train_step(cfg, mesh, make_pretrain_loss_fn(trainer.model, cfg))
    local = local_example([trainer.prepare_batch(e) for e in examples], mesh)
    aux = step(trainer.state, trainer.model, local, torch.as_tensor(uniforms))
    return {"grads": grads, "aux": {k: v.numpy() for k, v in aux.items()}, "step": trainer.state.step,
            "params": {k: p.detach().numpy() for k, p in trainer.model.named_parameters()},
            "shard": float(shard_batch({"r": torch.arange(2.0)}, mesh)["r"])}


def ranks4(rank: int, scenes: dict) -> dict:
    return {"mesh": mesh_checks(), "render": render_all(scenes, 4)}


def ranks2(rank: int, scenes: dict, state: dict, examples: list, uniforms: np.ndarray) -> dict:
    return {"render": render_all(scenes, 2), "dp": dp_step(rank, state, examples, uniforms)}


# --- the parent's side -----------------------------------------------------------

@pytest.fixture(scope="module")
def jx():
    return jax_modules()


@pytest.fixture(scope="module")
def scenes(jx):
    """test_parallel.py's two scenes from the JAX package's make_scene, one view, numpy."""
    out = {}
    for name, (seed, n, kw) in {"render": (0, 150, RENDER_KW), "grad": (1, 50, GRAD_KW)}.items():
        s = jx.tr.make_scene(jx.jax.random.PRNGKey(seed), n=n)
        out[name] = ({k: np.asarray(v[0]) for k, v in s.items()}, kw)
    return out


def fresh_copy(tree):
    """Every array copied, with the strides a rank receives it with (pickling
    copies it so): collate_batch's arrays have a zero stride on their batch
    axis, and torch's CPU convolutions round differently by strides."""
    if isinstance(tree, dict):
        return {k: fresh_copy(v) for k, v in tree.items()}
    return tree.copy() if isinstance(tree, np.ndarray) else tree


def dataset_examples() -> list:
    ds = tds.SyntheticPlanesDataset(tds.SyntheticSceneSpec(n_views=8, image_size=(32, 64)), num_source_views=3)
    return [fresh_copy(tds.collate_batch(ds[i])) for i in range(2)]


def draw_shape(cfg, example) -> tuple:
    probe = GGRtTrainer(cfg, device="cpu")
    return tuple(probe.draw_uniforms(probe.prepare_batch(example)).shape)


@pytest.fixture(scope="module")
def dp_case():
    """The dp step's inputs: the configuration's weights, the 32x64 scene's
    views 0 and 1, one set of numpy uniforms for both ranks. The step runs
    at step 1."""
    cfg = dp_config()
    trainer = GGRtTrainer(cfg, device="cpu")
    trainer.init_full()
    examples = dataset_examples()
    u = np.random.RandomState(3).uniform(size=draw_shape(cfg, examples[0])).astype(np.float32)
    return dict(state={k: v.numpy() for k, v in trainer.model.state_dict().items()}, examples=examples, u=u)


@pytest.fixture(scope="module")
def run4(scenes):
    return spawn(ranks4, 4, "cpu", args=(scenes,), timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def run2(scenes, dp_case):
    return spawn(ranks2, 2, "cpu", args=(scenes, dp_case["state"], dp_case["examples"], dp_case["u"]),
                 timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def runs(run2, run4):
    return {2: run2, 4: run4}


def close_to_scale(actual, expected, rtol=1e-4, name=""):
    scale = max(float(np.abs(expected).max()), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=rtol * scale, err_msg=name)


def test_mesh_rules_at_world_4(run4, jx):
    """JAX's test_axes and test_default_fill at world 4, the first dp·tp
    ranks, the errors; JAX's make_mesh on 4 devices gives the same shapes
    and refuses the same meshes."""
    devices = jx.jax.devices()[:4]
    for rank, r in enumerate(run4):
        m = r["mesh"]
        assert m["axes"] == (2, 2) and m["fill"] == (2, 2) and m["fill_tp1"] == (4, 1)
        assert m["names"] == ("dp", "tp")
        assert m["subset"] == ((0, rank) if rank < 2 else None)
        assert "does not divide" in m["tp3"] and "exceeds" in m["3x2"]
    for args, shape in (((2, 2), (2, 2)), ((0, 2), (2, 2)), ((0, 1), (4, 1)), ((1, 2), (1, 2))):
        jm = jx.make_mesh(*args, devices=devices)
        assert (jm.shape["dp"], jm.shape["tp"]) == shape
    for args in ((0, 3), (3, 2)):
        with pytest.raises(AssertionError):
            jx.make_mesh(*args, devices=devices)


def unsharded(scene, kw, backend, grad):
    """api.render of the one view (near 1: the world rescale is exact)."""
    means = torch.tensor(scene["means"][None], requires_grad=grad)
    bg = torch.tensor(scene["background"][None], requires_grad=grad)
    rest = [torch.tensor(scene[k][None]) for k in SCENE_ARGS[1:]]
    with torch.set_grad_enabled(grad):
        img = api.render(*rest[3:], SHAPE, bg, means, *rest[:3], backend=backend, **kw)[0]
    if not grad:
        return img.numpy(), None
    return img.detach().numpy(), [g.numpy() for g in torch.autograd.grad((img ** 2).mean(), (means, bg))]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
def test_tile_parallel_equals_unsharded(runs, scenes, tp, backend):
    """Every rank's image equals api.render's with the same backend, and
    its gradients (means, background) the unsharded gradients."""
    for name, (scene, kw) in scenes.items():
        img, grads = unsharded(scene, kw, backend, name == "grad")
        for rank, r in enumerate(runs[tp]):
            got = r["render"][name, backend]
            np.testing.assert_allclose(got["img"], img, atol=1e-5, rtol=1e-4, err_msg=f"{name} rank {rank}")
            if grads:
                close_to_scale(got["means"], grads[0][0], name=f"means rank {rank}")
                close_to_scale(got["background"], grads[1][0], name=f"background rank {rank}")


@pytest.fixture(scope="module")
def jax_tp(jx, scenes):
    """JAX's render_tile_parallel, "tiled", on make_mesh(1, tp) of the 8
    virtual devices: the render scene's image, the gradient scene's
    jax.grad of mean(img²) with respect to the means."""
    jnp = jx.jnp
    out = {}
    for tp in (2, 4):
        mesh = jx.make_mesh(data_parallel=1, tile_parallel=tp)
        scene, kw = scenes["render"]
        args = [jnp.asarray(scene[k]) for k in SCENE_ARGS]
        img = jx.render_tile_parallel(mesh, *args, SHAPE, jnp.asarray(scene["background"]), **kw)
        scene, kw = scenes["grad"]
        args = [jnp.asarray(scene[k]) for k in SCENE_ARGS]
        bg = jnp.asarray(scene["background"])

        def loss(means):
            return jnp.mean(jx.render_tile_parallel(mesh, means, *args[1:], SHAPE, bg, **kw) ** 2)

        out[tp] = (np.asarray(img), np.asarray(jx.jax.jit(jx.jax.grad(loss))(args[0])))
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
def test_tile_parallel_equals_jax(runs, jax_tp, tp, backend):
    """Every rank's image and means gradient against JAX's tile-parallel
    "tiled" render on the same tp (JAX's own Pallas case is slow, so the
    port's "cuda" case is held against JAX's "tiled" one, as JAX's dryrun
    holds its two)."""
    img, grad = jax_tp[tp]
    for rank, r in enumerate(runs[tp]):
        np.testing.assert_allclose(r["render"]["render", backend]["img"], img, atol=1e-5, rtol=1e-4,
                                   err_msg=f"rank {rank}")
        close_to_scale(r["render"]["grad", backend]["means"], grad, name=f"rank {rank}")
    assert np.abs(grad).max() > 0


def single_process_step(case) -> dict:
    """The mean of the two examples' gradients taken one after the other in
    this process, then the same gated, clipped update."""
    cfg = dp_config()
    trainer = GGRtTrainer(cfg, device="cpu")
    trainer.init_full()
    trainer.model.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()})
    loss_fn = make_pretrain_loss_fn(trainer.model, cfg)
    params = [p for p in trainer.model.parameters() if p.requires_grad]
    grads, auxes = [], []
    for ex in case["examples"]:
        trainer.state.zero_grad()
        loss, aux = loss_fn(trainer.prepare_batch(ex), 1, torch.as_tensor(case["u"]))
        loss.backward()
        grads.append([p.grad if p.grad is not None else torch.zeros_like(p) for p in params])
        auxes.append({k: v.detach() for k, v in aux.items()})
    for p, a, b in zip(params, *grads):
        p.grad = (a + b) / 2
    mean = {k: p.grad.numpy().copy() for k, p in trainer.model.named_parameters()}
    trainer.state.apply_updates(tstate.STATE_JOINT)
    return {"grads": mean, "aux": {k: ((auxes[0][k] + auxes[1][k]) / 2).numpy() for k in auxes[0]},
            "params": {k: p.detach().numpy() for k, p in trainer.model.named_parameters()}}


def test_dp_step_equals_mean_of_gradients(run2, dp_case):
    """dp 2: the averaged gradients, the aux and the parameters after the
    step equal the single-process mean of the two examples' gradients
    followed by the same update, bit for bit, on both ranks (rank 1 began
    from other weights: replicate copies rank 0's)."""
    want = single_process_step(dp_case)
    for rank, r in enumerate(run2):
        got = r["dp"]
        assert got["step"] == 2
        for what in ("grads", "aux", "params"):
            assert sorted(got[what]) == sorted(want[what]), what
            for k in want[what]:
                np.testing.assert_array_equal(got[what][k], want[what][k], err_msg=f"rank {rank} {what} {k}")
    for part in ("pose_learner.", "gaussian."):
        assert any(np.abs(g).max() > 0 for k, g in want["grads"].items() if k.startswith(part)), part


def test_dp_ranks_stay_equal_and_take_their_shard(run2):
    """The two ranks' parameters agree bit for bit; shard_batch gives rank
    r the r-th slice of a stacked batch."""
    a, b = (r["dp"]["params"] for r in run2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert [r["dp"]["shard"] for r in run2] == [0.0, 1.0]


@pytest.mark.slow
def test_dp_step_matches_jax(jx, dp_case):
    """JAX's make_dp_train_step on make_mesh(2, 1) of the virtual devices
    against the port's dp 2 step from the same (JAX-made) weights, examples
    and uniforms (JAX's draw patched to them on both devices): aux to rtol
    1e-4; the parameters after by tests/test_torch_train.py's criterion (at
    least 99% of the moved elements within 1% of their tensor's largest
    update plus two ulps: Adam's first step is sign-like). Slow: JAX builds
    its params in ~24 s and compiles the dp step in ~64 s on the CPU."""
    import jax.numpy as jnp

    from ggrt_official_tpu.data import datasets as jds
    from ggrt_official_tpu.models import depth_predictor as jdp
    from ggrt_official_tpu.models.ggrt import GGRtModel as JModel
    from ggrt_official_tpu.parallel import sharded_step as jss
    from ggrt_official_tpu.training import state as jstate
    from ggrt_official_tpu.training.trainer import GGRtTrainer as JTrainer
    from ggrt_official_tpu.training.trainer import make_pretrain_loss_fn as jloss
    from ggrt_official_torch import weights
    from tests.test_torch_finetune import patched_sampler
    from tests.test_torch_models import port_cfg

    jax = jx.jax
    cfg = jx.graft._dryrun_cfg()
    for k, v in DP_OVERRIDES.items():
        setattr(cfg.train, k.split(".")[1], v)
    assert port_cfg(cfg).train == dp_config().train and port_cfg(cfg).encoder == dp_config().encoder
    ds = jds.SyntheticPlanesDataset(jds.SyntheticSceneSpec(n_views=8, image_size=(32, 64)), num_source_views=3)
    jt = JTrainer(cfg)
    examples = [jt.prepare_batch(jds.collate_batch(ds[i])) for i in range(2)]
    model = JModel(cfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jb = examples[0]
    pose = jax.jit(lambda b: model.init(
        {"params": k1}, b["rgb"], b["src_rgbs"], b["camera"], b["src_cameras"],
        b["depth_range"][0, 0], b["depth_range"][0, 1], compute_sfm_loss=False, method="iponet"))(jb)
    gauss = jax.jit(lambda b: model.init({"params": k1, "sample": k2}, b, 0, deterministic=True,
                                         method="gaussian_forward"))(jb)
    params = {"params": {"pose_learner": pose["params"]["pose_learner"], "gaussian": gauss["params"]["gaussian"]}}
    pcfg = dp_config()
    before = {k: v.numpy() for k, v in weights.ggrt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), pcfg).items()}
    u = dp_case["u"]
    mp = pytest.MonkeyPatch()
    mp.setattr(jdp, "sample_discrete_distribution", patched_sampler({u.shape[2]: jnp.asarray(u)}))
    try:
        mesh = jx.make_mesh(data_parallel=2, tile_parallel=1)
        step = jss.make_dp_train_step(cfg, mesh, jloss(model, cfg))
        state, jaux = step(jstate.create_train_state(cfg, params)._replace(step=jnp.asarray(1, jnp.int32)),
                           jss.shard_batch(jss.stack_examples(examples), mesh),
                           jax.random.split(jax.random.PRNGKey(0), 2))
        jaux = jax.tree_util.tree_map(np.asarray, jaux)
        after = {k: v.numpy() for k, v in weights.ggrt_params_from_jax(
            jax.tree_util.tree_map(np.asarray, state.params), pcfg).items()}
    finally:
        mp.undo()
    run = spawn(ranks2, 2, "cpu", args=({}, before, dp_case["examples"], u), timeout=SPAWN_TIMEOUT)
    for r in run:
        got = r["dp"]
        for key in ("loss_all", "gaussian_loss", "sfm_loss", "depth_loss", "psnr"):
            np.testing.assert_allclose(got["aux"][key], jaux[key], rtol=1e-4, atol=1e-6, err_msg=key)
        within = moved = 0
        for k, p in got["params"].items():
            dj, dt = after[k] - before[k], p - before[k]
            tol = 1e-2 * np.abs(dj).max() + 2 * np.spacing(np.abs(before[k]))
            within += int((np.abs(dt - dj) <= tol).sum())
            moved += dj.size
        assert within >= 0.99 * moved, within / moved


def test_dryrun_multichip_on_four_cpu_ranks():
    """dryrun_multichip(4, "cpu"): both tile-parallel renders agree, and the
    dp 2 x tp 2 train step gives a finite loss."""
    out = dryrun_multichip(4, device="cpu", timeout=SPAWN_TIMEOUT)
    assert [m.split(" ")[0] for m, _ in out["stages"]] == ["tp4", "tp4", "dp2xtp2"]
    assert out["render_err"] < 1e-3 and (out["dp"], out["tp"]) == (2, 2)
    assert math.isfinite(out["loss"]) and math.isfinite(out["psnr"])


@pytest.mark.parametrize("fn, arg", [(render_tile_parallel, "backend"), (make_mesh, "device_type")])
def test_entry_points_default_to_the_card(fn, arg):
    """The tile-parallel render composites with the kernels and the mesh
    lies on the card unless the caller asks otherwise."""
    assert inspect.signature(fn).parameters[arg].default == "cuda"


def test_dryrun_cli_takes_one_rank_per_card(monkeypatch):
    """The CLI spawns one rank per card by default and refuses more ranks
    than cards on cuda, where NCCL takes one rank per card."""
    from ggrt_official_torch.parallel import dryrun

    ran = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dryrun, "dryrun_multichip", lambda n, device: ran.append((n, device)))
    dryrun.main([])
    dryrun.main(["--device", "cpu"])
    assert ran == [(1, "cuda"), (8, "cpu")]
    with pytest.raises(SystemExit, match="one rank per card"):
        dryrun.main(["--n", "2"])


def test_dryrun_config_is_the_jax_dryrun_config(jx):
    import dataclasses

    from tests.test_torch_models import port_cfg

    assert dataclasses.asdict(config.dryrun_config()) == dataclasses.asdict(port_cfg(jx.graft._dryrun_cfg()))
