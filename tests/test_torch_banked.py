"""The port's binning modes and capacity statistics
(ggrt_official_torch.ops.rasterizer.{tiling,banked_gather}) against the JAX
package's, on the CPU, on the same numpy-seeded screen-space inputs: every
list, count and statistic must be equal.

The JAX banked-gather kernel runs in Pallas interpret mode, as
tests/test_segment_sum.py runs it; the port's wrapper runs its plain
PyTorch version because the tensors lie on the CPU. The CUDA kernel itself
is held against the plain version by tests/test_torch_gpu.py and
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ggrt_official_tpu.ops.rasterizer import banked_gather as jbg
from ggrt_official_tpu.ops.rasterizer import projection as jproj
from ggrt_official_tpu.ops.rasterizer import tiling as jtiling
from ggrt_official_torch.ops.rasterizer import banked_gather as tbg
from ggrt_official_torch.ops.rasterizer import projection as tproj
from ggrt_official_torch.ops.rasterizer import tiling as ttiling

# (image, tile, K): 8x128 tiles over 32x256 (2 tiles wide), 16x16 and 8x32
# tiles, and 64x96 at 8x128 (one tile wide: the tall-window regime, win 1x8).
# Every K truncates: some tile holds K entries.
CASES = [
    ((32, 256), (8, 128), 128), ((32, 256), (8, 128), 256),
    ((32, 256), (16, 16), 128), ((32, 256), (16, 16), 256),
    ((32, 256), (8, 32), 128), ((32, 256), (8, 32), 256),
    ((64, 96), (8, 128), 128), ((64, 96), (8, 128), 256),
]
CASE_IDS = [f"{s[0]}x{s[1]}-tile{t[0]}x{t[1]}-K{k}" for s, t, k in CASES]


def population(seed=0, n=4000, ties=0, spread=1.0):
    """Camera at the origin looking +z; `ties` extra Gaussians share one
    depth and one spot, so their quantized keys tie inside one group."""
    rng = np.random.RandomState(seed)
    z = rng.uniform(1.2, 6.0, n)
    means = np.stack([rng.uniform(-0.6, 0.6, n) * z * spread,
                      rng.uniform(-0.4, 0.4, n) * z * spread, z], -1)
    if ties:
        means = np.concatenate([means, np.tile([[0.3, 0.1, 3.0]], (ties, 1))])
        n += ties
    s = rng.uniform(0.01, 0.06, (n, 3))
    return dict(
        means=means, covariances=np.einsum("ni,ij->nij", s * s, np.eye(3)),
        sh_coeffs=rng.normal(size=(n, 3, 4)) * 0.3, opacities=rng.uniform(0.1, 0.9, n),
        extrinsics=np.eye(4), intrinsics=np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]),
        near=np.array(1.0), far=np.array(25.0),
    )


ARGS = ("means", "covariances", "sh_coeffs", "opacities", "extrinsics", "intrinsics", "near", "far")


def project(pop, shape):
    """Screen-space Gaussians as numpy; both packages bin these same values
    (tests/test_torch_rasterizer.py holds the projections together)."""
    pg = tproj.project_gaussians(*(torch.tensor(pop[k], dtype=torch.float32) for k in ARGS), shape)
    return tproj.ProjectedGaussians(*(x.numpy() for x in pg))


def jpg(pg):
    return jproj.ProjectedGaussians(*(jnp.asarray(x) for x in pg))


def tpg(pg):
    return tproj.ProjectedGaussians(*(torch.tensor(x) for x in pg))


def assert_lists_equal(port, ref, name=""):
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts), err_msg=name)
    np.testing.assert_array_equal(port.gaussian_ids.numpy(), np.asarray(ref.gaussian_ids), err_msg=name)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's banked and counting lists, once per module."""
    out = {}
    for shape, tile, K in CASES:
        pg = project(population(), shape)
        out[(shape, tile, K)] = pg, jax.jit(lambda p: jtiling.bin_gaussians_banked(
            p, shape, 8, K, *tile, merge="flat"))(jpg(pg))
    shape, tile = (32, 256), (16, 16)
    pg = project(population(), shape)
    out["counting"] = pg, jax.jit(lambda p: jtiling.bin_gaussians_counting(
        p, shape, 8, 128, *tile))(jpg(pg))
    return out


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_banked_lists_equal_jax(jax_side, case):
    """Both merges of the port (the kernel branch with its plain gather on
    the CPU, and the per-slot branch) give JAX's lists at a truncating K."""
    pg, ref = jax_side[case]
    shape, tile, K = case
    for merge in ("flat", "sort"):
        b = ttiling.bin_gaussians_banked(tpg(pg), shape, 8, K, *tile, merge=merge)
        assert_lists_equal(b, ref, merge)
    assert int(np.asarray(ref.counts).max()) == K


def spy_gather(monkeypatch):
    calls = []
    real = tbg.gather_streams

    def spy(*a, **kw):
        calls.append(kw["budgets"])
        return real(*a, **kw)

    monkeypatch.setattr(tbg, "gather_streams", spy)
    return calls


@pytest.mark.parametrize("shape,max_dup,kernel", [
    ((32, 256), 8, True), ((32, 256), 16, True), ((32, 256), 32, False),
    ((64, 96), 8, True), ((64, 96), 16, False),
])
def test_kernel_gate(monkeypatch, shape, max_dup, kernel):
    """The kernel takes window shapes nxw | nyw << 2 below 64: max_dup 32
    (win 2x16) and, one tile wide, max_dup 16 (win 1x16) take the per-slot
    branch, in the JAX package and in the port; the lists equal JAX's."""
    pg = project(population(), shape)
    calls = spy_gather(monkeypatch)
    b = ttiling.bin_gaussians_banked(tpg(pg), shape, max_dup, 256, merge="flat")
    ntx = -(-shape[1] // 128)
    assert ttiling.banked_uses_kernel(4000, ntx, max_dup) == kernel
    assert bool(calls) == kernel
    ref = jax.jit(lambda p: jtiling.bin_gaussians_banked(p, shape, max_dup, 256))(jpg(pg))
    assert_lists_equal(b, ref)
    assert not ttiling.banked_uses_kernel(4000, ntx, 8, merge="sort")


@pytest.mark.parametrize("shape,tile", [((32, 256), (8, 128)), ((64, 96), (8, 128)),
                                        ((32, 256), (8, 32))])
def test_plain_gather_matches_pallas_kernel(shape, tile):
    """gather_streams_plain against the Pallas kernel (interpret mode) on
    the descriptors banked binning builds: both int32 outputs equal."""
    pg = project(population(), shape)
    s = ttiling.banked_streams(tpg(pg), shape, 8, 128, *tile)
    kw = dict(budgets=list(s.budgets), dydx=list(s.dydx), qbits=s.qbits, num_tiles=s.num_tiles)
    launches = tbg.gather_streams.launches
    packed, gid = tbg.gather_streams(s.key_sorted, s.gw_sorted, s.al, s.lo, s.hi, **kw)
    assert tbg.gather_streams.launches == launches, "a CPU call launched no kernel"
    with pltpu.force_tpu_interpret_mode():
        jpk, jgid = jbg.gather_streams(*(jnp.asarray(x.numpy()) for x in s[:5]), **kw)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpk))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(jgid))
    valid = gid != tbg.INVALID_GID
    assert valid.any() and (~valid).any()


def test_gather_rejects_bad_descriptors():
    pg = project(population(), (32, 256))
    s = ttiling.banked_streams(tpg(pg), (32, 256), 8, 128)
    kw = dict(budgets=s.budgets, dydx=s.dydx, qbits=s.qbits, num_tiles=s.num_tiles)
    with pytest.raises(ValueError):      # not padded past the last window
        tbg.gather_streams(s.key_sorted[:600], s.gw_sorted[:600], s.al, s.lo, s.hi, **kw)
    with pytest.raises(ValueError):      # a budget off the 128 grid
        tbg.gather_streams(*s[:5], **{**kw, "budgets": (100,) + s.budgets[1:]})
    with pytest.raises(ValueError):
        tbg.gather_streams(s.key_sorted, s.gw_sorted, s.al[:, :3], s.lo, s.hi, **kw)


def test_tied_depths_at_a_truncating_budget():
    """600 Gaussians at one spot and one depth: their keys tie inside one
    group, and the (0, 0) stream's budget of 128 cuts through the tie. Both
    sorts are stable (jax.lax.sort by default, torch.sort(stable=True)), so
    the cut keeps the lowest ids in both packages."""
    shape = (32, 256)
    pg = project(population(n=500, ties=600), shape)
    ref = jax.jit(lambda p: jtiling.bin_gaussians_banked(p, shape, 8, 128))(jpg(pg))
    for merge in ("flat", "sort"):
        assert_lists_equal(ttiling.bin_gaussians_banked(tpg(pg), shape, 8, 128, merge=merge), ref)
    ids = np.asarray(ref.gaussian_ids)
    kept = [row[row >= 500] for row in ids]
    # Rows that reach the tie keep a prefix of it, in id order; it is cut.
    assert max(len(k) for k in kept) > 0
    for k in kept:
        np.testing.assert_array_equal(np.sort(k), np.arange(500, 500 + len(k)))
        assert len(k) < 600


def test_counting_equals_jax_and_sort(jax_side):
    pg, ref = jax_side["counting"]
    b = ttiling.bin_gaussians_counting(tpg(pg), (32, 256), 8, 128, 16, 16)
    assert_lists_equal(b, ref)
    assert_lists_equal(b, ttiling.bin_gaussians(tpg(pg), (32, 256), 8, 128, 16, 16))
    assert int(b.counts.max()) == 128


@pytest.mark.parametrize("max_dup,K", [(1, 8), (8, 128), (64, 4096)])
def test_overflow_stats_equal_jax(max_dup, K):
    shape = (32, 256)
    pg = project(population(), shape)
    ref = jtiling.binning_overflow_stats(jpg(pg), shape, max_dup=max_dup, max_per_tile=K,
                                         tile_h=16, tile_w=16)
    got = ttiling.binning_overflow_stats(tpg(pg), shape, max_dup=max_dup, max_per_tile=K,
                                         tile_h=16, tile_w=16)
    assert set(got) == set(ref)
    for k in ref:
        if k == "recall":
            assert float(got[k]) == float(ref[k]), k
        else:
            assert int(got[k]) == int(ref[k]), k


@pytest.mark.parametrize("shape,tile", [((32, 128), (8, 128)), ((64, 96), (16, 16))])
def test_recommend_max_per_tile_equal_jax(shape, tile):
    pg = project(population(), shape)
    ref = jtiling.recommend_max_per_tile(jpg(pg), shape, max_dup=8, tile_h=tile[0], tile_w=tile[1])
    got = ttiling.recommend_max_per_tile(tpg(pg), shape, max_dup=8, tile_h=tile[0], tile_w=tile[1])
    # mean_alpha: a float32 sum over the Gaussians in another order.
    np.testing.assert_allclose(got.pop("mean_alpha"), ref.pop("mean_alpha"), rtol=1e-6)
    assert got == ref


def test_exact_rank_fallback_equals_jax():
    """1024x512 at 1x1 tiles: 524,288 tiles leave 11 depth bits, so sort
    binning falls back to exact depth ranks; the lists equal JAX's, and the
    counting mode's (float depth keys there) equal them too."""
    shape = (1024, 512)
    pg = project(population(n=300, spread=0.03), shape)
    assert ttiling._qbits(512 * 1024) < ttiling._MIN_DEPTH_BITS
    ref = jax.jit(lambda p: jtiling.bin_gaussians(p, shape, 32, 8, 1, 1))(jpg(pg))
    b = ttiling.bin_gaussians(tpg(pg), shape, 32, 8, 1, 1)
    assert_lists_equal(b, ref)
    assert int(b.counts.max()) == 8 and int((b.counts > 0).sum()) > 100
    assert_lists_equal(ttiling.bin_gaussians_counting(tpg(pg), shape, 32, 8, 1, 1), ref)
