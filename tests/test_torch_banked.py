"""The port's binning modes and capacity statistics
(ggrt_official_torch.ops.rasterizer.{tiling,banked_gather}) against the JAX
package's, on the CPU, on the same numpy-seeded screen-space inputs: every
list, count and statistic must be equal.

The JAX banked-gather kernel runs in Pallas interpret mode, as
tests/test_segment_sum.py runs it; the port's wrapper runs its plain
PyTorch version because the tensors lie on the CPU. The CUDA kernel's
algorithm (compaction of each slot's valid entries, then a rank merge of
the sorted runs) is written out in torch here and held against the plain
version; the kernel itself is held against the plain version by
tests/test_torch_gpu.py and chip_smoke.py.
"""
import importlib.util
import math
from pathlib import Path

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

ROOT = Path(__file__).resolve().parents[1]

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


def spy_lists(monkeypatch):
    calls = []
    real = tbg.banked_lists

    def spy(*a, **kw):
        calls.append(kw["budgets"])
        return real(*a, **kw)

    monkeypatch.setattr(tbg, "banked_lists", spy)
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
    calls = spy_lists(monkeypatch)
    b = ttiling.bin_gaussians_banked(tpg(pg), shape, max_dup, 256, merge="flat")
    ntx = -(-shape[1] // 128)
    assert ttiling.banked_uses_kernel(4000, ntx, max_dup, 256) == kernel
    assert bool(calls) == kernel
    ref = jax.jit(lambda p: jtiling.bin_gaussians_banked(p, shape, max_dup, 256))(jpg(pg))
    assert_lists_equal(b, ref)
    assert not ttiling.banked_uses_kernel(4000, ntx, 8, 256, merge="sort")


@pytest.mark.parametrize("shape,tile", [((32, 256), (8, 128)), ((64, 96), (8, 128)),
                                        ((32, 256), (8, 32))])
def test_plain_gather_matches_pallas_kernel(shape, tile):
    """gather_streams_plain against the Pallas kernel (interpret mode) on
    the descriptors banked binning builds: both int32 outputs equal. On the
    CPU banked_lists runs its plain version and launches nothing."""
    pg = project(population(), shape)
    s = ttiling.banked_streams(tpg(pg), shape, 8, 128, *tile)
    kw = dict(budgets=list(s.budgets), dydx=list(s.dydx), qbits=s.qbits, num_tiles=s.num_tiles)
    launches = tbg.banked_lists.launches
    packed, gid = tbg.gather_streams_plain(s.key_sorted, s.gw_sorted, s.al, s.lo, s.hi, **kw)
    ids, counts = tbg.banked_lists(*s[:5], **kw, max_per_tile=128)
    assert tbg.banked_lists.launches == launches, "a CPU call launched no kernel"
    with pltpu.force_tpu_interpret_mode():
        jpk, jgid = jbg.gather_streams(*(jnp.asarray(x.numpy()) for x in s[:5]), **kw)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpk))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(jgid))
    valid = gid != tbg.INVALID_GID
    assert valid.any() and (~valid).any()
    assert torch.equal(counts, torch.clamp(valid.sum(dim=1, dtype=torch.int32), max=128))


def test_gather_rejects_bad_descriptors():
    pg = project(population(), (32, 256))
    s = ttiling.banked_streams(tpg(pg), (32, 256), 8, 128)
    kw = dict(budgets=s.budgets, dydx=s.dydx, qbits=s.qbits, num_tiles=s.num_tiles,
              max_per_tile=128)
    with pytest.raises(ValueError):      # not padded past the last window
        tbg.banked_lists(s.key_sorted[:600], s.gw_sorted[:600], s.al, s.lo, s.hi, **kw)
    with pytest.raises(ValueError):      # a budget off the 128 grid
        tbg.banked_lists(*s[:5], **{**kw, "budgets": (100,) + s.budgets[1:]})
    with pytest.raises(ValueError):
        tbg.banked_lists(s.key_sorted, s.gw_sorted, s.al[:, :3], s.lo, s.hi, **kw)
    with pytest.raises(ValueError):      # K past the tile's columns
        tbg.banked_lists(*s[:5], **{**kw, "max_per_tile": 10**6})


def slot_runs(st, t):
    """Tile t's valid entries, slot by slot, as the kernel compacts them:
    keys q << 31 | gid (int64) in window order."""
    n = st.key_sorted.shape[0]
    qmask = (1 << st.qbits) - 1
    runs = []
    for s, (b, (dy, dx)) in enumerate(zip(st.budgets, st.dydx)):
        pos = int(st.al[t, s]) * tbg.ALIGN + torch.arange(b + tbg.ALIGN)
        p = pos.clamp(0, n - 1)
        key, gw = st.key_sorted[p].long(), st.gw_sorted[p].long()
        win = gw >> tbg.GID_BITS
        valid = ((pos >= 0) & (pos < n) & (pos >= int(st.lo[t, s])) & (pos < int(st.hi[t, s]))
                 & (dy < (win >> 2)) & (dx < (win & 3)))
        runs.append((((key & qmask) << 31) | (gw & tbg.GID_MASK))[valid])
    return runs


def rank_merge(st, K):
    """The kernel's merge in torch: entry i of run s goes to rank i plus its
    lower bound in every other run, entries at i >= K skipped; (ids, counts)
    as banked_lists gives them. Asserts that the ranks are a permutation."""
    ids = torch.full((st.num_tiles, K), -1, dtype=torch.long)
    counts = torch.zeros(st.num_tiles, dtype=torch.int32)
    for t in range(st.num_tiles):
        runs = slot_runs(st, t)
        n_valid = sum(len(r) for r in runs)
        ranks = []
        for s, r in enumerate(runs):
            x = r[:K]
            rank = torch.arange(len(x)) + sum(
                (torch.searchsorted(r2, x) for s2, r2 in enumerate(runs) if s2 != s),
                torch.zeros(len(x), dtype=torch.long))
            ranks.append(rank)
            ids[t, rank[rank < K]] = x[rank < K] & tbg.GID_MASK
        ranks = torch.cat(ranks)
        assert len(torch.unique(ranks)) == len(ranks)
        assert torch.equal(torch.sort(ranks[ranks < K]).values, torch.arange(min(n_valid, K)))
        counts[t] = min(n_valid, K)
    return ids, counts


MERGE_IDS = CASE_IDS + ["ties", "empty-tiles"]


@pytest.fixture(scope="module")
def merge_streams():
    """The streams of CASES, of the 600-way tie and of an image with empty
    tiles, by id: (streams, K)."""
    out = {}
    for name, (shape, tile, K) in zip(CASE_IDS, CASES):
        out[name] = ttiling.banked_streams(tpg(project(population(), shape)), shape, 8, K, *tile), K
    pg = project(population(n=500, ties=600), (32, 256))
    out["ties"] = ttiling.banked_streams(tpg(pg), (32, 256), 8, 128), 128
    pg = project(population(n=300, spread=0.2), (64, 256))
    out["empty-tiles"] = ttiling.banked_streams(tpg(pg), (64, 256), 8, 128, 16, 16), 128
    return out


@pytest.mark.parametrize("name", MERGE_IDS[:-1])
def test_slot_runs_are_sorted_and_disjoint(merge_streams, name):
    """The merge's premise on the real streams: each (tile, slot)'s valid
    entries strictly increase in q << 31 | gid, and no gid lies in two slots
    of one tile (the slots read different groups)."""
    st, _ = merge_streams[name]
    seen = 0
    for t in range(st.num_tiles):
        runs = slot_runs(st, t)
        for r in runs:
            assert bool((r[1:] > r[:-1]).all()), (t, r)
        gids = torch.cat(runs) & tbg.GID_MASK
        assert len(torch.unique(gids)) == len(gids)
        seen += len(gids)
    assert seen > 0


@pytest.mark.parametrize("name", MERGE_IDS)
def test_rank_merge_equals_flat_sort(merge_streams, name):
    """The kernel's algorithm (compaction, searchsorted ranks, the i >= K
    skip) gives banked_lists_plain's lists, empty tiles included."""
    st, K = merge_streams[name]
    kw = dict(budgets=st.budgets, dydx=st.dydx, qbits=st.qbits, num_tiles=st.num_tiles,
              max_per_tile=K)
    ids_p, counts_p = tbg.banked_lists_plain(*st[:5], **kw)
    ids, counts = rank_merge(st, K)
    assert torch.equal(counts, counts_p) and torch.equal(ids, ids_p)
    assert int(counts.max()) > 0
    if name == "empty-tiles":
        assert int((counts == 0).sum()) > 0


@pytest.mark.parametrize("name", MERGE_IDS)
def test_bound_counts_the_runs(merge_streams, name):
    """chip_smoke's bound of the banked kernel counts each word that some
    run [lo, hi) covers once, 10 operations per run entry and the merge's
    compares per valid entry: the lists read nothing else of the windows."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    st, K = merge_streams[name]
    T, S = st.lo.shape
    n_valid = sum(len(r) for t in range(T) for r in slot_runs(st, t))
    ops, nbytes, entries = cs.banked_lists_work(st, K, n_valid)
    covered = set()
    for lo, hi in zip(st.lo.reshape(-1).tolist(), st.hi.reshape(-1).tolist()):
        covered.update(range(lo, hi))
    assert entries == int((st.hi - st.lo).sum()) >= n_valid
    assert nbytes == 8 * len(covered) + 12 * T * S + 8 * T * K + 4 * T
    assert ops == 10 * entries + math.ceil(math.log2(S)) * n_valid


def test_shared_memory_gate(monkeypatch):
    """A K whose budgets need more than a block's 232,448 bytes of shared
    memory takes the per-slot branch, with JAX's lists; the K values of the
    raster scales (1024 at 320x448, 4 tiles across; 256 at 640x960, 8
    across) stay inside and take the kernel."""
    shape = (32, 256)
    budgets = lambda K: ttiling._banked_budgets(K, 2, 8)[0]
    assert tbg.smem_bytes(budgets(4224)) <= tbg.SMEM_LIMIT < tbg.smem_bytes(budgets(4352))
    assert ttiling.banked_uses_kernel(4000, 2, 8, 4224)
    assert not ttiling.banked_uses_kernel(4000, 2, 8, 4352)
    assert ttiling.banked_uses_kernel(860_160, 4, 8, 1024)
    assert ttiling.banked_uses_kernel(3_686_400, 8, 8, 256)
    assert tbg.smem_bytes(budgets(1024)) == 66_560 and tbg.smem_bytes(budgets(256)) == 37_888
    pg = project(population(), shape)
    calls = spy_lists(monkeypatch)
    b = ttiling.bin_gaussians_banked(tpg(pg), shape, 8, 4352, merge="flat")
    assert not calls
    ref = jax.jit(lambda p: jtiling.bin_gaussians_banked(p, shape, 8, 4352))(jpg(pg))
    assert_lists_equal(b, ref)


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
