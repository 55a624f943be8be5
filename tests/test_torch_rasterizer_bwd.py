"""The port's rasterizer backward against the JAX package's, on the CPU:
the plain backward compositor against the Pallas `_bwd_raw` kernel and the
plain scatter against the Pallas `scatter_add_rows` kernel, both in
interpret mode as the JAX package's own tests run them, and torch autograd
of the whole `api.render` against `jax.grad` of the JAX `render` with the
Pallas backend. The CUDA kernels are held against the plain versions by
tests/test_torch_gpu.py and chip_smoke.py.
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
from ggrt_official_tpu.ops.rasterizer.segment_sum import scatter_add_rows as j_scatter
from ggrt_official_torch.ops.rasterizer import api as tapi
from ggrt_official_torch.ops.rasterizer import cuda_composite as tcc
from ggrt_official_torch.ops.rasterizer import segment_sum as tss
from tests.test_torch_gpu import saturating_tile
from tests.test_torch_rasterizer import K, SHAPE, make_scene

ARGS = ("means", "covariances", "sh_coeffs", "opacities", "extrinsics", "intrinsics", "near", "far")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work, whatever worker and
    order it runs in: a reduction that torch splits across threads sums in
    an order that depends on the thread count, and two test files set the
    count at import."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close_to_scale(actual, expected, rtol=1e-4, name=""):
    """|actual - expected| <= rtol·max|expected| everywhere: the same float32
    formulas, with the cumprod and the suffix sums taken in another order
    (sequential against the TPU kernel's lane rolls)."""
    actual, expected = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    scale = np.abs(expected).max()
    assert scale > 0, name
    np.testing.assert_allclose(actual, expected, rtol=0, atol=rtol * scale, err_msg=name)


def jax_records(tile, ragged):
    """Records of the test scene for one tile shape, from the JAX package;
    `ragged` empties every fourth tile and cuts every fourth+1 to 50."""
    scene = make_scene()
    pg = jproj.project_gaussians(*(jnp.asarray(scene[k][0]) for k in ARGS), SHAPE)
    b = jtiling.bin_gaussians(pg, SHAPE, max_dup=32, max_per_tile=K, tile_h=tile[0], tile_w=tile[1])
    rec, col, cnt = jpc.build_records(pg, b, *tile)
    cnt = np.asarray(cnt)[:, 0].astype(np.int32)
    if ragged:
        cnt[::4] = 0
        cnt[1::4] = np.minimum(cnt[1::4], 50)
    return np.asarray(rec), np.asarray(col), cnt


CASES = {
    "8x128": lambda: (*jax_records((8, 128), False), (8, 128)),
    "16x16-ragged": lambda: (*jax_records((16, 16), True), (16, 16)),
    "saturating": lambda: (*(x.numpy() for x in saturating_tile("cpu")), (8, 128)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_pallas_kernel(case):
    rec, col, cnt, tile = CASES[case]()
    rng = np.random.RandomState(0)
    t, P = rec.shape[0], tile[0] * tile[1]
    gout = rng.normal(size=(t, P, 4)).astype(np.float32)
    gtfin = rng.normal(size=(t, P, 1)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, tfin_j, tst_j, nexec_j = jpc._fwd_raw(jnp.asarray(rec), jnp.asarray(col),
                                                 jnp.asarray(cnt, jnp.float32)[:, None], *tile)
        drec_j, dcol_j = jpc._bwd_raw(jnp.asarray(rec), jnp.asarray(col), tst_j, nexec_j, tfin_j,
                                      jnp.asarray(gout), jnp.asarray(gtfin), *tile)
    _, tfin, tst, nexec = tcc.composite_fwd(torch.tensor(rec), torch.tensor(col), torch.tensor(cnt), *tile)
    np.testing.assert_array_equal(nexec.numpy(), np.asarray(nexec_j)[:, 0, 0].astype(np.int32))
    launches = tcc.composite_bwd.launches
    drec, dcol = tcc.composite_bwd(torch.tensor(rec), torch.tensor(col), tst, nexec, tfin,
                                   torch.tensor(gout), torch.tensor(gtfin), *tile)
    assert tcc.composite_bwd.launches == launches, "a CPU call launched no kernel"
    close_to_scale(drec.numpy(), drec_j, name="drec")
    close_to_scale(dcol.numpy(), dcol_j, name="dcol")
    assert (drec[:, 6:] == 0).all() and (dcol[:, 3] == 0).all()


def test_plain_backward_is_the_forward_gradient():
    """The hand-written formulas against torch autograd through the plain
    forward compositor."""
    rec, col, cnt, tile = CASES["16x16-ragged"]()
    rec_t = torch.tensor(rec, requires_grad=True)
    col_t = torch.tensor(col, requires_grad=True)
    acc, tfin, tst, nexec = tcc.composite_records_plain(rec_t, col_t, torch.tensor(cnt), *tile)
    gen = torch.Generator().manual_seed(0)
    gout, gtfin = torch.randn(acc.shape, generator=gen), torch.randn(tfin.shape, generator=gen)
    auto = torch.autograd.grad((acc * gout).sum() + (tfin * gtfin).sum(), (rec_t, col_t))
    plain = tcc.composite_bwd_plain(rec_t.detach(), col_t.detach(), tst.detach(), nexec,
                                    tfin.detach(), gout, gtfin, *tile)
    close_to_scale(plain[0][:, :6].numpy(), auto[0][:, :6].numpy(), name="drec")
    close_to_scale(plain[1][:, :3].numpy(), auto[1][:, :3].numpy(), name="dcol")


@pytest.fixture
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def scatter_case(ids, vals, g):
    got = tss.scatter_add_rows(torch.tensor(np.asarray(ids)), torch.tensor(np.asarray(vals)), g)
    want = j_scatter(jnp.asarray(ids), jnp.asarray(vals), jnp.zeros((g, vals.shape[1]), jnp.float32))
    # float32 sums of a few rows in another order.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    return got


@pytest.mark.parametrize("n,g,c", [(500, 300, 9), (4000, 5000, 9)])
def test_plain_scatter_matches_pallas_kernel(interpret_mode, n, g, c):
    rng = np.random.RandomState(n)
    ids = rng.randint(0, g, n).astype(np.int32)
    ids[rng.rand(n) < 0.3] = g                       # dump rows
    scatter_case(ids, rng.normal(size=(n, c)).astype(np.float32), g)


def test_plain_scatter_block_edges_and_empty(interpret_mode):
    g = 5000
    ids = np.concatenate([np.full(64, v, np.int32) for v in (2047, 2048, 4095, g, 0)])
    launches = tss.scatter_add_rows.launches
    out = scatter_case(ids, np.ones((ids.shape[0], 3), np.float32), g)
    assert tss.scatter_add_rows.launches == launches
    assert out[2047, 0] == 64 and out[2048, 0] == 64 and out[4095, 0] == 64
    empty = scatter_case(np.full(256, 100, np.int32), np.ones((256, 4), np.float32), 100)
    assert (empty == 0).all()


def test_gather_rows_pullback():
    """GatherRows' backward scatters the live rows and drops dead ids."""
    comp = torch.randn(6, 9, requires_grad=True)
    ids = torch.tensor([[0, 2, 2, -1], [5, -1, -1, -1]])
    gath = tcc.GatherRows.apply(comp, ids)
    np.testing.assert_array_equal(gath.detach().numpy(), comp.detach()[ids.clamp(min=0)].numpy())
    cot = torch.randn(gath.shape)
    (grad,) = torch.autograd.grad((gath * cot).sum(), comp)
    want = torch.zeros(6, 9)
    for (t, k), i in np.ndenumerate(ids.numpy()):
        if i >= 0:
            want[i] += cot[t, k]
    np.testing.assert_allclose(grad.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tile", [(8, 128), (16, 16)])
def test_render_gradients_match_jax(tile):
    """d(sum(image·cot))/d(means, covariances, SH, opacities): torch
    autograd through the port's render (plain kernels on the CPU) against
    jax.grad of the JAX render with the Pallas backend in interpret mode.
    Tolerance 2e-4 of each gradient's largest entry: the same formulas, in
    float32, summed in other orders through projection, records and the
    compositor."""
    scene = make_scene()
    cams = [scene[k] for k in ("extrinsics", "intrinsics", "near", "far")]
    names = ("means", "covariances", "sh_coeffs", "opacities")
    cot = np.random.RandomState(1).normal(size=(1, 3, *SHAPE)).astype(np.float32)
    kw = dict(max_per_tile=K, tile_shape=tile)

    def jloss(m, c, s, o):
        img = japi.render(*map(jnp.asarray, cams), SHAPE, jnp.asarray(scene["background"]),
                          m, c, s, o, backend="pallas", **kw)
        return jnp.sum(img * cot)

    with pltpu.force_tpu_interpret_mode():
        jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(*(jnp.asarray(scene[k]) for k in names))
    leaves = [torch.tensor(scene[k], requires_grad=True) for k in names]
    img = tapi.render(*map(torch.tensor, cams), SHAPE, torch.tensor(scene["background"]),
                      *leaves, backend="cuda", **kw)
    tgrads = torch.autograd.grad((img * torch.tensor(cot)).sum(), leaves)
    for name, a, b in zip(names, tgrads, jgrads):
        close_to_scale(a.numpy(), b, rtol=2e-4, name=name)


def test_gaussian_on_the_camera_plane_keeps_gradients_finite():
    """A Gaussian exactly on the camera plane (view z = 0) is culled, so the
    image is that of the scene without it; its projection's Jacobian is
    infinite there, and the gradient must stay finite all the same."""
    scene = make_scene()
    scene["means"][0, 0] = [-1.0, 0.2, 0.0]
    cams = [torch.tensor(scene[k]) for k in ("extrinsics", "intrinsics", "near", "far")]
    names = ("means", "covariances", "sh_coeffs", "opacities")
    leaves = [torch.tensor(scene[k], requires_grad=True) for k in names]
    kw = dict(max_per_tile=K, tile_shape=(8, 128), backend="cuda")
    img = tapi.render(*cams, SHAPE, torch.tensor(scene["background"]), *leaves, **kw)
    without = tapi.render(*cams, SHAPE, torch.tensor(scene["background"]),
                          *(x.detach()[:, 1:] for x in leaves), **kw)
    np.testing.assert_array_equal(img.detach().numpy(), without.numpy())
    grads = torch.autograd.grad(img.sum(), leaves)
    for name, grad in zip(names, grads):
        assert torch.isfinite(grad).all(), name
        assert (grad[:, 0] == 0).all(), name
