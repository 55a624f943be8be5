"""The port's rasterizer (ggrt_official_torch.ops.rasterizer) against the JAX
package's on the same numpy inputs, on the CPU.

The JAX compositor kernel runs in Pallas interpret mode, as
tests/test_pallas.py runs it; the port's wrapper runs its plain PyTorch
version because the tensors lie on the CPU. The CUDA kernel itself is held
against the plain version by tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ggrt_official_tpu.ops.rasterizer import api as japi
from ggrt_official_tpu.ops.rasterizer import pallas_composite as jpc
from ggrt_official_tpu.ops.rasterizer import projection as jproj
from ggrt_official_tpu.ops.rasterizer import tiling as jtiling
from ggrt_official_torch.ops.rasterizer import api as tapi
from ggrt_official_torch.ops.rasterizer import cuda_composite as tcc
from ggrt_official_torch.ops.rasterizer import projection as tproj
from ggrt_official_torch.ops.rasterizer import tiling as ttiling

SHAPE = (24, 256)
TILE_SHAPES = [(8, 128), (16, 16)]
K = 256  # two 128-Gaussian chunks per tile


def make_scene(seed=0, n=400, batch=1, d_sh=25):
    """Random Gaussians in front of a camera at the origin looking +z. The
    means sit in the lower left of the frame, so the right-hand tiles stay
    empty (count 0) and the top ones hold less than one chunk."""
    rng = np.random.RandomState(seed)
    means = np.stack([
        rng.uniform(-1.5, -0.5, (batch, n)),
        rng.uniform(0.0, 0.4, (batch, n)),
        rng.uniform(2.0, 8.0, (batch, n)),
    ], axis=-1)
    scales = rng.uniform(0.02, 0.12, (batch, n, 3))
    q = rng.normal(size=(batch, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    i, j, k, r = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.stack([
        1 - 2 * (j * j + k * k), 2 * (i * j - k * r), 2 * (i * k + j * r),
        2 * (i * j + k * r), 1 - 2 * (i * i + k * k), 2 * (j * k - i * r),
        2 * (i * k - j * r), 2 * (j * k + i * r), 1 - 2 * (i * i + j * j),
    ], axis=-1).reshape(batch, n, 3, 3)
    cov = np.einsum("bnij,bnj,bnkj->bnik", R, scales**2, R)
    scene = dict(
        extrinsics=np.broadcast_to(np.eye(4), (batch, 4, 4)),
        intrinsics=np.broadcast_to(
            np.array([[0.6, 0.0, 0.5], [0.0, 5.0, 0.5], [0.0, 0.0, 1.0]]), (batch, 3, 3)),
        near=np.full((batch,), 1.0),
        far=np.full((batch,), 20.0),
        background=np.full((batch, 3), 0.1),
        means=means,
        covariances=cov,
        sh_coeffs=rng.normal(size=(batch, n, 3, d_sh)) * 0.3,
        opacities=rng.uniform(0.2, 0.95, (batch, n)),
    )
    return {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in scene.items()}


def jx(x):
    return jnp.asarray(x)


def tt(x):
    return torch.tensor(np.asarray(x))


def image_close(actual, expected, name):
    """Mean abs < 1e-5 and under 2e-3 of pixels off by more than 2e-3: the
    two compositors sum in another order (running product against
    cumprod), so a pixel may flip across the 1/255 or 1e-4 cut-offs and
    its maximum error is no measure (bench.py:127-135 compares the same
    way)."""
    err = np.abs(np.asarray(actual, np.float64) - np.asarray(expected, np.float64))
    assert err.mean() < 1e-5, f"{name}: mean abs {err.mean():.3g}"
    assert (err > 2e-3).mean() < 2e-3, f"{name}: outlier share {(err > 2e-3).mean():.3g}"


def _pg_numpy(scene):
    pg = jproj.project_gaussians(
        *(jx(scene[k][0]) for k in ("means", "covariances", "sh_coeffs", "opacities",
                                    "extrinsics", "intrinsics", "near", "far")),
        SHAPE,
    )
    return jproj.ProjectedGaussians(*(np.asarray(x) for x in pg))


@pytest.fixture(scope="module")
def jax_side():
    """Everything computed by the JAX package, once per module."""
    scene = make_scene()
    pg = _pg_numpy(scene)
    out = {"scene": scene, "pg": pg}
    with pltpu.force_tpu_interpret_mode():
        for th, tw in TILE_SHAPES:
            b = jtiling.bin_gaussians(
                jproj.ProjectedGaussians(*(jx(x) for x in pg)), SHAPE,
                max_dup=32, max_per_tile=K, tile_h=th, tile_w=tw)
            rec, col, cnt = jpc.build_records(
                jproj.ProjectedGaussians(*(jx(x) for x in pg)), b, th, tw)
            fwd = jpc._fwd_raw(rec, col, cnt, th, tw)
            out[(th, tw)] = dict(
                ids=np.asarray(b.gaussian_ids), counts=np.asarray(b.counts),
                records=np.asarray(rec), colors=np.asarray(col), rec_counts=np.asarray(cnt),
                fwd=[np.asarray(x) for x in fwd],
            )
            kw = dict(backend="pallas", max_per_tile=K, tile_shape=(th, tw))
            out[(th, tw, "rgb")] = np.asarray(japi.render(
                *(jx(scene[k]) for k in ("extrinsics", "intrinsics", "near", "far")), SHAPE,
                *(jx(scene[k]) for k in ("background", "means", "covariances", "sh_coeffs",
                                         "opacities")), **kw))
            out[(th, tw, "depth")] = np.asarray(japi.render_depth(
                *(jx(scene[k]) for k in ("extrinsics", "intrinsics", "near", "far")), SHAPE,
                *(jx(scene[k]) for k in ("means", "covariances", "opacities")), **kw))
    return out


def test_project_gaussians(jax_side):
    scene, pg_j = jax_side["scene"], jax_side["pg"]
    pg_t = tproj.project_gaussians(
        *(tt(scene[k][0]) for k in ("means", "covariances", "sh_coeffs", "opacities",
                                    "extrinsics", "intrinsics", "near", "far")),
        SHAPE,
    )
    # float32 with the matrix products summed in another order: rtol 1e-5.
    for name in ("mean2d", "conic", "depth", "color", "opacity"):
        np.testing.assert_allclose(getattr(pg_t, name).numpy(), getattr(pg_j, name),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # Integer-pixel metadata: equal.
    for name in ("radius", "extent", "valid"):
        np.testing.assert_array_equal(getattr(pg_t, name).numpy(), getattr(pg_j, name),
                                      err_msg=name)


def _pg_torch(pg):
    return tproj.ProjectedGaussians(*(tt(x) for x in pg))


@pytest.mark.parametrize("tile", TILE_SHAPES)
def test_bin_gaussians_equal(jax_side, tile):
    """Same screen-space inputs -> identical lists: the stable sort breaks
    ties by duplicate index in both."""
    ref = jax_side[tile]
    b = ttiling.bin_gaussians(_pg_torch(jax_side["pg"]), SHAPE, max_dup=32,
                              max_per_tile=K, tile_h=tile[0], tile_w=tile[1])
    np.testing.assert_array_equal(b.counts.numpy(), ref["counts"])
    np.testing.assert_array_equal(b.gaussian_ids.numpy(), ref["ids"])
    # The scene covers what the compositor must handle: empty tiles,
    # tiles of one partial chunk and tiles past one chunk.
    assert (ref["counts"] == 0).any() and (ref["counts"] > 128).any()
    assert ((ref["counts"] > 0) & (ref["counts"] < 128)).any()


@pytest.mark.parametrize("tile", TILE_SHAPES)
def test_build_records(jax_side, tile):
    ref = jax_side[tile]
    b = ttiling.bin_gaussians(_pg_torch(jax_side["pg"]), SHAPE, max_dup=32,
                              max_per_tile=K, tile_h=tile[0], tile_w=tile[1])
    rec, col, cnt = tcc.build_records(_pg_torch(jax_side["pg"]), b, *tile)
    # Same float32 formulas, elementwise: rtol 1e-5.
    np.testing.assert_allclose(rec.numpy(), ref["records"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(col.numpy(), ref["colors"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cnt.numpy(), ref["rec_counts"][:, 0].astype(np.int32))


@pytest.mark.parametrize("tile", TILE_SHAPES)
def test_plain_compositor_matches_pallas_kernel(jax_side, tile):
    ref = jax_side[tile]
    acc_j, tfin_j, tst_j, nexec_j = ref["fwd"]
    launches = tcc.composite_fwd.launches
    acc, tfin, tst, nexec = tcc.composite_fwd(
        tt(ref["records"]), tt(ref["colors"]),
        tt(ref["rec_counts"][:, 0].astype(np.int32)), *tile)
    assert tcc.composite_fwd.launches == launches, "a CPU call launched no kernel"
    np.testing.assert_array_equal(nexec.numpy(), nexec_j[:, 0, 0].astype(np.int32))
    # cumprod by rolls (TPU) against a sequential cumprod: a few float32
    # ulps on T, amplified by at most the colour sum.
    np.testing.assert_allclose(tst.numpy(), tst_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tfin.numpy(), tfin_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(acc.numpy(), acc_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile", TILE_SHAPES)
def test_render_matches_jax(jax_side, tile):
    scene = jax_side["scene"]
    kw = dict(backend="cuda", max_per_tile=K, tile_shape=tile)
    rgb = tapi.render(
        *(tt(scene[k]) for k in ("extrinsics", "intrinsics", "near", "far")), SHAPE,
        *(tt(scene[k]) for k in ("background", "means", "covariances", "sh_coeffs",
                                 "opacities")), **kw)
    depth = tapi.render_depth(
        *(tt(scene[k]) for k in ("extrinsics", "intrinsics", "near", "far")), SHAPE,
        *(tt(scene[k]) for k in ("means", "covariances", "opacities")), **kw)
    assert rgb.shape == (1, 3, *SHAPE) and depth.shape == (1, *SHAPE)
    image_close(rgb.numpy(), jax_side[(*tile, "rgb")], "rgb")
    image_close(depth.numpy(), jax_side[(*tile, "depth")], "depth")


def test_backend_names():
    scene = make_scene(n=8)
    args = [tt(scene[k]) for k in ("extrinsics", "intrinsics", "near", "far")]
    rest = [tt(scene[k]) for k in ("background", "means", "covariances", "sh_coeffs",
                                   "opacities")]
    a = tapi.render(*args, SHAPE, *rest, backend="pallas", max_per_tile=128)
    b = tapi.render(*args, SHAPE, *rest, backend="cuda", max_per_tile=128)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for name in ("tiled", "reference"):
        image_close(tapi.render(*args, SHAPE, *rest, backend=name, max_per_tile=128).numpy(),
                    b.numpy(), name)
    with pytest.raises(ValueError):
        tapi.render(*args, SHAPE, *rest, backend="xla")
    with pytest.raises(ValueError):
        tapi.render(*args, SHAPE, *rest, binning_mode="radix")


def test_wrapper_rejects_bad_shapes():
    rec = torch.zeros(2, 8, 100)
    with pytest.raises(ValueError):
        tcc.composite_fwd.launch(rec, torch.zeros(2, 4, 100), torch.zeros(2, dtype=torch.int32), 8, 128)
    with pytest.raises(ValueError):
        tcc.composite_fwd.launch(torch.zeros(2, 8, 128), torch.zeros(2, 4, 128),
                                 torch.zeros(2, dtype=torch.int32), 64, 64)


def test_constants_made_in_inference_mode_serve_autograd():
    """The render path takes its constants from constants.device_constant,
    made on the first call. A first render under torch.inference_mode() (a
    served request) must not leave inference tensors there: a later render
    with gradients (a train step) saves them for backward. The images of
    the two calls are equal, bit for bit."""
    from ggrt_official_torch.constants import device_constant

    sc = {k: torch.tensor(v, dtype=torch.float32) for k, v in make_scene().items()}
    args = [sc[k] for k in ("extrinsics", "intrinsics", "near", "far")]
    leaves = [sc[k] for k in ("background", "means", "covariances", "sh_coeffs", "opacities")]
    device_constant.cache_clear()
    with torch.inference_mode():
        served = tapi.render(*args, SHAPE, *leaves)
    means = leaves[1].clone().requires_grad_(True)
    img = tapi.render(*args, SHAPE, leaves[0], means, *leaves[2:])
    img.square().mean().backward()
    assert torch.equal(img.detach(), served) and torch.isfinite(means.grad).all()
