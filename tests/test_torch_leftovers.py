"""The five JAX functions that were left without a port until the
visualization slice, against the JAX package on the CPU:
geometry/projection.py's transform_world2cam and project, ops/sh.py's
num_sh_coeffs, SyntheticPlanesDataset.depth_map and
MultiViewPhotometricDecayLoss. Each test states its tolerance.
"""
import jax
import numpy as np
import pytest
import torch

from ggrt_official_torch.data import datasets as tds
from ggrt_official_torch.geometry import projection as tproj
from ggrt_official_torch.losses import photometric as tphoto
from ggrt_official_torch.ops import sh as tsh
from ggrt_official_tpu.data import datasets as jds
from ggrt_official_tpu.geometry import projection as jproj
from ggrt_official_tpu.losses import photometric as jphoto
from ggrt_official_tpu.ops import sh as jsh


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.tensor(np.asarray(x))


def close(actual, expected, **tol):
    actual = actual.detach().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    np.testing.assert_allclose(actual, np.asarray(expected), **tol)


def poses(n, seed):
    rng = np.random.RandomState(seed)
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        out[i, :3, :3] = q * np.sign(np.linalg.det(q))
        out[i, :3, 3] = rng.randn(3)
    return out


def test_transform_world2cam_and_project():
    """Homogeneous points into (b, n) cameras and their projection with the
    in-front mask, points in front and behind: rtol 1e-5, atol 1e-5; the
    mask equal."""
    rng = np.random.RandomState(0)
    ext = poses(2, 1)[:, None]
    K = np.array([[0.9, 0, 0.5], [0, 1.1, 0.4], [0, 0, 1]], np.float32)[None, None]
    pts = rng.uniform(-3, 3, (2, 50, 3)).astype(np.float32)
    hom = np.concatenate([pts, np.ones_like(pts[..., :1])], -1)
    close(tproj.transform_world2cam(t(hom), t(ext)), jax.jit(jproj.transform_world2cam)(hom, ext),
          rtol=1e-5, atol=1e-5)
    xy_t, front_t = tproj.project(t(pts), t(ext), t(K))
    xy_j, front_j = jax.jit(jproj.project)(pts, ext, K)
    np.testing.assert_array_equal(front_t.numpy(), np.asarray(front_j))
    assert 0 < front_t.numpy().mean() < 1
    close(xy_t, xy_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("degree", range(5))
def test_num_sh_coeffs(degree):
    assert tsh.num_sh_coeffs(degree) == jsh.num_sh_coeffs(degree) == (degree + 1) ** 2


@pytest.mark.parametrize("binary_alpha", [True, False])
def test_depth_map(binary_alpha):
    """The expected first-surface depth of several views of one scene: the
    same numpy arithmetic, bit for bit."""
    kw = dict(n_views=6, image_size=(24, 32), binary_alpha=binary_alpha)
    tdset = tds.SyntheticPlanesDataset(tds.SyntheticSceneSpec(**kw))
    jdset = jds.SyntheticPlanesDataset(jds.SyntheticSceneSpec(**kw))
    for i in (0, 3, 5):
        got = tdset.depth_map(i)
        assert got.shape == (24, 32) and got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_array_equal(got, jdset.depth_map(i))


def test_multiview_photometric_decay_loss():
    """The class calls photometric_decay_loss with its settings: the loss
    and metrics of JAX's class, rtol 1e-5 (test_torch_train.py's bound for
    the function itself)."""
    rng = np.random.RandomState(7)
    h, w, nv, n_it = 24, 32, 3, 2
    image = rng.uniform(size=(1, 3, h, w)).astype(np.float32)
    refs = rng.uniform(size=(nv, 3, h, w)).astype(np.float32)
    inv = rng.uniform(0.2, 1.0, (n_it, 1, 1, h, w)).astype(np.float32)
    p = (rng.normal(size=(1, nv, n_it, 6)) * 0.05).astype(np.float32)
    K = np.array([[[30.0, 0, 15.5], [0, 30.0, 11.5], [0, 0, 1]]], np.float32)
    Ks = np.repeat(K, nv, axis=0)
    kw = dict(ssim_weight=0.5, smooth_weight=0.05, valid_mask=True, oob_weight=0.5)
    want = jax.jit(lambda *a: jphoto.MultiViewPhotometricDecayLoss(**kw)(*a))(image, refs, inv, K, Ks, p)
    got = tphoto.MultiViewPhotometricDecayLoss(**kw)(t(image), t(refs), t(inv), t(K), t(Ks), t(p))
    close(got["loss"], want["loss"], rtol=1e-5)
    assert set(got["metrics"]) == set(want["metrics"])
    for k in want["metrics"]:
        close(got["metrics"][k], want["metrics"][k], rtol=1e-5, atol=1e-7, err_msg=k)
