"""The port's cross-iteration Gaussian cache against the JAX package, on the
CPU: GaussianCache, CachedPairEncoder on JAX's hit/miss/eviction case, and
CachedGGRtTrainer over JAX's three-batch sequence (tests/test_training.py::
TestCachedTrainer): a window of misses, the same window again (all hits), a
slid window (partial hits).

Inputs are made with numpy from a seed and given to both sides; parameters
are made by the JAX package and reach the port through
`ggrt_official_torch.weights`. The JAX decoder renders with its tiled
backend, the port's with the plain versions of its kernels. Each test
states its tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ggrt_official_tpu.data import datasets as jds
from ggrt_official_tpu.models import depth_predictor as jdp
from ggrt_official_tpu.models.gaussian_adapter import Gaussians as JGaussians
from ggrt_official_tpu.models.ggrt import GGRtModel as JModel
from ggrt_official_tpu.training import gaussian_cache as jcache
from ggrt_official_tpu.training import state as jstate
from ggrt_official_tpu.training.trainer import GGRtTrainer as JTrainer
from ggrt_official_tpu.training.trainer_cached import CachedGGRtTrainer as JCached
from ggrt_official_torch import weights
from ggrt_official_torch.data import datasets as tds
from ggrt_official_torch.models.gaussian_adapter import Gaussians
from ggrt_official_torch.training import gaussian_cache as tcache
from ggrt_official_torch.training.trainer_cached import CachedGGRtTrainer as TCached
from tests.test_torch_eval import one_torch_thread  # noqa: F401  (module fixture)
from tests.test_torch_finetune import gaussians_close, patched_sampler
from tests.test_torch_models import port_cfg
from tests.test_torch_train import close, t

# --- the cache and the pair encoder ----------------------------------------------


def fake_gaussians(pkg, val, n=4, requires_grad=False):
    if pkg == "jax":
        f = jnp.full
        return JGaussians(means=f((1, n, 3), val), covariances=f((1, n, 3, 3), val),
                          harmonics=f((1, n, 3, 4), val), opacities=f((1, n), val),
                          scales=f((1, n, 3), val), rotations=f((1, n, 4), val))
    f = lambda shape: torch.full(shape, float(val), requires_grad=requires_grad)
    return Gaussians(means=f((1, n, 3)), covariances=f((1, n, 3, 3)), harmonics=f((1, n, 3, 4)),
                     opacities=f((1, n)), scales=f((1, n, 3)), rotations=f((1, n, 4)))


def test_pair_encoder_matches_jax():
    """JAX's hit/miss/eviction case (tests/test_infra.py:93-125) through both
    packages' CachedPairEncoder: the same pairs encoded in the same order,
    the same hits, misses and cache keys after each call, and the same
    merged Gaussians."""
    contexts = [np.array([[2, 0, 1]]), np.array([[2, 0, 1]]), np.array([[3, 1, 2]])]
    calls = {"jax": [], "port": []}

    def encoder(pkg):
        def encode_pair(pair):
            key = float(np.asarray(pair["index"][0, 0]))
            calls[pkg].append(key)
            return fake_gaussians(pkg, key)
        return encode_pair

    encs = {"jax": jcache.CachedPairEncoder(encoder("jax")), "port": tcache.CachedPairEncoder(encoder("port"))}
    expected = [(2, 0), (2, 2), (3, 3)]
    for index, (misses, hits) in zip(contexts, expected):
        g_j = encs["jax"]({"index": jnp.asarray(index), "image": jnp.zeros((1, 3, 3, 4, 4))})
        g_t = encs["port"]({"index": torch.as_tensor(index), "image": torch.zeros(1, 3, 3, 4, 4)})
        assert (encs["port"].misses, encs["port"].hits) == (encs["jax"].misses, encs["jax"].hits) == (misses, hits)
        assert list(encs["port"].cache.store) == list(encs["jax"].cache.store)
        assert calls["port"] == calls["jax"]
        for a, b in zip(g_t, g_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert g_t.means.shape == (1, 8, 3) and 0 not in encs["port"].cache.store


def test_cache_evicts_and_detaches():
    """evict_unused drops the keys outside the window, then the oldest past
    the capacity (insertion order), as JAX's does; `put` stores detached
    tensors, so `get` returns them; `nbytes` counts every stored tensor."""
    caches = {"jax": jcache.GaussianCache(capacity=2), "port": tcache.GaussianCache(capacity=2)}
    for pkg, cache in caches.items():
        for key in (5, 1, 7, 3):
            cache.put(key, fake_gaussians(pkg, key, requires_grad=True))
        cache.evict_unused([1, 3, 5])
    assert list(caches["port"].store) == list(caches["jax"].store) == [1, 3]
    assert not any(x.requires_grad for g in caches["port"].store.values() for x in g)
    got = caches["port"].get(3)
    assert not any(x.requires_grad for x in got) and float(got.means[0, 0, 0]) == 3.0
    assert caches["port"].get(5) is None
    assert caches["port"].nbytes() == 2 * 4 * 4 * (3 + 9 + 12 + 1 + 3 + 4)


# --- the cached trainer ----------------------------------------------------------

MACHINES = ("joint", "joint", "nerf_only")


@pytest.fixture(scope="module")
def seq_case():
    """JAX's three-batch sequence (dataset views 0, 0, 1 of the 32x64
    synthetic scene with 3 source views) at _dryrun_cfg() widths (one GRU
    step: JAX compiles one step per distinct set of missing pairs, three
    here, each about 30 s on the CPU at these widths and 50 s at
    _tiny_cfg()'s), with the dataset's poses, the depth loss on and joint
    coefficient 0.5 so that both loss terms count; machines joint, joint,
    nerf_only. JAX runs it once with its sampler's draws fixed (one set for
    every pair); the port gets the same draws."""
    cfg = graft._dryrun_cfg()
    cfg.train.use_pred_pose = False
    cfg.train.use_depth_loss = True
    cfg.train.joint_coefficient = 0.5
    ds = jds.SyntheticPlanesDataset(jds.SyntheticSceneSpec(n_views=8, image_size=(32, 64)), num_source_views=3)
    seq = [jds.collate_batch(ds[i]) for i in (0, 0, 1)]
    model = JModel(cfg)
    jb = JTrainer(cfg).prepare_batch(seq[0])
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
    u = np.random.RandomState(3).uniform(
        size=(1, 2, 32 * 64, enc.num_surfaces, enc.gaussians_per_pixel)).astype(np.float32)

    mp = pytest.MonkeyPatch()
    mp.setattr(jdp, "sample_discrete_distribution", patched_sampler({32 * 64: jnp.asarray(u)}))
    try:
        jt = JCached(cfg)
        jt.state = jstate.create_train_state(cfg, params)
        runs = []
        for batch, machine in zip(seq, MACHINES):
            aux = jax.tree_util.tree_map(np.asarray, jt.train_iteration(batch, machine))
            runs.append(dict(aux=aux, hits=jt.hits, misses=jt.misses,
                             params=weights.ggrt_params_from_jax(
                                 jax.tree_util.tree_map(np.asarray, jt.state.params), pcfg),
                             cache={k: jax.tree_util.tree_map(np.asarray, g) for k, g in jt.cache.store.items()}))
    finally:
        mp.undo()
    before = weights.ggrt_params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg)
    return dict(pcfg=pcfg, seq=[tds.collate_batch(tds.SyntheticPlanesDataset(
        tds.SyntheticSceneSpec(n_views=8, image_size=(32, 64)), num_source_views=3)[i]) for i in (0, 0, 1)],
        before=before, runs=runs, u=u)


def test_cached_trainer_matches_jax(seq_case):
    """Each step: loss_all, gaussian_loss, sfm_loss and psnr to rtol 1e-4;
    hits and misses (0/2, 2/2, 3/3) and the cache's keys equal; each cached
    entry by test_finetune.py::gaussians_close. The parameters after each
    step by test_torch_train.py::check_step's criterion, against the
    parameters before the sequence: at least 99% of the elements within 1%
    of their tensor's largest change plus two ulps (Adam's updates are
    sign-like where a gradient is near its rounding error). Every cached
    tensor is detached."""
    c = seq_case
    tt = TCached(c["pcfg"], device="cpu")
    tt.init_full()
    tt.model.load_state_dict(c["before"])
    u = t(c["u"])
    for i, (batch, machine, run) in enumerate(zip(c["seq"], MACHINES, c["runs"])):
        missing = run["misses"] - (c["runs"][i - 1]["misses"] if i else 0)
        aux = tt.train_iteration(batch, machine, uniforms=[u] * missing)
        for key in ("loss_all", "gaussian_loss", "sfm_loss", "psnr"):
            close(aux[key], run["aux"][key], rtol=1e-4, atol=1e-6, err_msg=f"step {i} {key}")
        assert (tt.hits, tt.misses) == (run["hits"], run["misses"]), i
        assert list(tt.cache.store) == list(run["cache"]), i
        for key, g in tt.cache.store.items():
            assert not any(x.requires_grad for x in g)
            for f in ("means", "covariances", "harmonics", "opacities"):
                gaussians_close(getattr(g, f).numpy(), getattr(run["cache"][key], f), f"step {i} {key} {f}")
        state = tt.model.state_dict()
        within = moved = 0
        for name, b0 in c["before"].items():
            if name not in dict(tt.model.named_parameters()):
                continue
            dj = (run["params"][name] - b0).numpy()
            dt = (state[name] - b0).numpy()
            tol = 1e-2 * np.abs(dj).max() + 2 * np.spacing(np.abs(b0.numpy()))
            within += int((np.abs(dt - dj) <= tol).sum())
            moved += dj.size
        assert within >= 0.99 * moved, (i, within / moved)
    assert [r["hits"] for r in c["runs"]] == [0, 2, 3] and [r["misses"] for r in c["runs"]] == [2, 2, 3]


def test_cached_trainer_draws_its_own(seq_case):
    """Without explicit draws the trainer draws one (1, 2, h·w, srf, gpp)
    set per missing pair from its generator. When every pair is a hit
    nothing is encoded or drawn, and in 'nerf_only' no loss term reaches a
    parameter: the step takes no backward and the gradients are zero."""
    tt = TCached(seq_case["pcfg"], device="cpu")
    tt.init_full()
    batch = seq_case["seq"][0]
    aux = tt.train_iteration(batch, "joint")
    assert np.isfinite(float(aux["loss_all"])) and (tt.hits, tt.misses) == (0, 2)
    start = tt.generator.get_state()
    aux = tt.train_iteration(batch, "nerf_only")
    assert torch.equal(tt.generator.get_state(), start)
    assert (tt.hits, tt.misses) == (2, 2) and np.isfinite(float(aux["loss_all"]))
    assert all(not p.grad.any() for p in tt.model.parameters())
    assert tt.state.step == 2
