"""Card-only tests of the port: the CUDA kernels (forward and backward
compositor at four tile shapes, segment-sum scatter, banked
gather-and-merge) against their plain PyTorch versions, and the rasterizer on the
card against the same code on the CPU. Every test here needs a CUDA card
and skips without one.

A card-only environment need not have JAX, and tests/conftest.py imports
it, so run this file without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from ggrt_official_torch.ops.rasterizer import (
    api, banked_gather, cuda_composite, projection, segment_sum, tiling,
)

pytestmark = pytest.mark.gpu

SHAPE = (64, 256)
TILES = [(8, 128), (16, 16), (8, 32), (8, 16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def image_close(actual, expected):
    """Mean abs < 1e-5 and under 2e-3 of elements off by more than 2e-3:
    the kernel's running product and the plain version's cumprod may put a
    pixel on either side of the 1/255 or 1e-4 cut-offs."""
    err = (actual.double().cpu() - expected.double().cpu()).abs()
    assert err.mean() < 1e-5, err.mean()
    assert (err > 2e-3).double().mean() < 2e-3


def scene(n=3000, seed=0):
    """Random Gaussians in front of a camera at the origin (numpy seed),
    concentrated on the left so that some tiles stay empty."""
    rng = np.random.RandomState(seed)
    means = np.stack([rng.uniform(-1.5, -0.2, n), rng.uniform(-0.5, 0.5, n),
                      rng.uniform(2.0, 8.0, n)], -1)
    s = rng.uniform(0.01, 0.08, (n, 3))
    out = dict(
        means=means, covariances=np.einsum("ni,ij->nij", s * s, np.eye(3)),
        sh_coeffs=rng.normal(size=(n, 3, 25)) * 0.3, opacities=rng.uniform(0.05, 0.95, n),
        extrinsics=np.eye(4), intrinsics=np.array([[0.8, 0, 0.5], [0, 3.2, 0.5], [0, 0, 1]]),
        near=np.array(1.0), far=np.array(20.0),
    )
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()}


ARGS = ("means", "covariances", "sh_coeffs", "opacities", "extrinsics", "intrinsics", "near", "far")


def records(sc, tile, K, device):
    pg = projection.project_gaussians(*(sc[k].to(device) for k in ARGS), SHAPE)
    b = tiling.bin_gaussians(pg, SHAPE, 32, K, *tile)
    return pg, b, cuda_composite.build_records(pg, b, *tile)


@pytest.mark.parametrize("tile", TILES)
def test_kernel_matches_plain(cuda, tile):
    _, _, (rec, col, cnt) = records(scene(), tile, 512, cuda)
    cnt = cnt.clone()
    cnt[::4] = 0                                   # empty tiles
    cnt[1::4] = torch.clamp(cnt[1::4], max=50)     # less than one chunk
    assert (cnt > 128).any()
    launches = cuda_composite.composite_fwd.launches
    kern = cuda_composite.composite_fwd(rec, col, cnt, *tile)
    torch.cuda.synchronize()
    assert cuda_composite.composite_fwd.launches == launches + 1
    plain = cuda_composite.composite_records_plain(rec, col, cnt, *tile)
    image_close(kern[0], plain[0])
    image_close(kern[1], plain[1])
    image_close(kern[2], plain[2])
    # Both follow the TPU kernel's per-chunk rule: every tile runs all its
    # chunks.
    torch.testing.assert_close(kern[3].cpu(), plain[3].cpu(), rtol=0, atol=0)
    assert (kern[3][cnt == 0] == 0).all()


def saturating_tile(device):
    """One 8x128 tile of two chunks. Chunk 0: a Gaussian of alpha 0.9, then
    alpha-0.99 ones, which cover every pixel: T goes 1 -> 0.1 -> 1e-3 and
    the next would take it below 1e-4, so each pixel stops there. Chunk 1:
    alpha-0.5 Gaussians, which the TPU kernel's rule accepts again from
    T = 1e-3 (three of them, down to 1.25e-4)."""
    K = 256
    rec = torch.zeros(1, 8, K)
    rec[:, 0] = rec[:, 3] = 1e-4          # footprints far wider than the tile
    rec[0, 5, :128] = 0.995               # clamped to 0.99
    rec[0, 5, 0] = 0.9
    rec[0, 5, 128:] = 0.5
    col = torch.zeros(1, 4, K)
    col[0, 0, :128] = 1.0                 # red in chunk 0, green in chunk 1
    col[0, 1, 128:] = 1.0
    return rec.to(device), col.to(device), torch.full((1,), K, dtype=torch.int32, device=device)


def test_saturating_tile_follows_per_chunk_rule(cuda):
    rec, col, cnt = saturating_tile(cuda)
    kern = cuda_composite.composite_fwd(rec, col, cnt, 8, 128)
    torch.cuda.synchronize()
    plain = cuda_composite.composite_records_plain(rec.cpu(), col.cpu(), cnt.cpu(), 8, 128)
    assert int(plain[3][0]) == 2 and int(kern[3][0]) == 2
    # Chunk 1 adds green: 5e-4 + 2.5e-4 + 1.25e-4.
    assert abs(float(plain[0][0, 0, 1]) - 8.75e-4) < 1e-6
    for a, b in zip(kern[:3], plain[:3]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-7)


def grad_close(actual, expected):
    """Errors relative to the largest expected entry: mean under 1e-6 and
    under 1e-3 of entries off by more than 1e-4. Both sum over the tile's
    pixels in other orders, the kernel takes each chunk's suffix as total
    minus prefix, and its running product and the plain version's cumprod
    may put a (pixel, Gaussian) on either side of the 1/255 or 1e-4
    cut-offs, which moves one entry by a whole term."""
    scale = expected.abs().max().clamp(min=1e-30)
    err = (actual.double().cpu() - expected.double().cpu()).abs() / scale.double().cpu()
    assert err.mean() < 1e-6, err.mean()
    assert (err > 1e-4).double().mean() < 1e-3, (err > 1e-4).double().mean()


@pytest.mark.parametrize("tile", TILES)
def test_backward_kernel_matches_plain(cuda, tile):
    _, _, (rec, col, cnt) = records(scene(), tile, 512, cuda)
    cnt = cnt.clone()
    cnt[::4] = 0
    cnt[1::4] = torch.clamp(cnt[1::4], max=50)
    acc, tfin, tst, nexec = cuda_composite.composite_fwd(rec, col, cnt, *tile)
    gen = torch.Generator(device=cuda).manual_seed(0)
    gout = torch.randn(acc.shape, generator=gen, device=cuda)
    gtfin = torch.randn(tfin.shape, generator=gen, device=cuda)
    launches = cuda_composite.composite_bwd.launches
    kern = cuda_composite.composite_bwd(rec, col, tst, nexec, tfin, gout, gtfin, *tile)
    torch.cuda.synchronize()
    assert cuda_composite.composite_bwd.launches == launches + 1
    plain = cuda_composite.composite_bwd_plain(rec, col, tst, nexec, tfin, gout, gtfin, *tile)
    grad_close(kern[0], plain[0])
    grad_close(kern[1], plain[1])
    assert (kern[0][:, 6:] == 0).all() and (kern[1][:, 3] == 0).all()
    assert (kern[0][cnt == 0] == 0).all()


def test_backward_on_saturating_tile(cuda):
    rec, col, cnt = saturating_tile(cuda)
    acc, tfin, tst, nexec = cuda_composite.composite_fwd(rec, col, cnt, 8, 128)
    # Random cotangents: with all-ones ones, d(alpha) of the first Gaussian
    # is 1 - (0.099 + ...)/0.1, a difference of equal terms, and both sides
    # give rounding noise.
    gen = torch.Generator(device=cuda).manual_seed(1)
    gout = torch.randn(acc.shape, generator=gen, device=cuda)
    gtfin = torch.randn(tfin.shape, generator=gen, device=cuda)
    kern = cuda_composite.composite_bwd(rec, col, tst, nexec, tfin, gout, gtfin, 8, 128)
    plain = cuda_composite.composite_bwd_plain(rec, col, tst, nexec, tfin, gout, gtfin, 8, 128)
    torch.cuda.synchronize()
    grad_close(kern[0], plain[0])
    grad_close(kern[1], plain[1])


def check_both(rec, col, cnt, tile, device):
    """Forward and backward kernels against the plain versions."""
    kern = cuda_composite.composite_fwd.launch(rec, col, cnt, *tile)
    torch.cuda.synchronize()
    plain = cuda_composite.composite_records_plain(rec, col, cnt, *tile)
    for a, b in zip(kern[:3], plain[:3]):
        image_close(a, b)
    assert torch.equal(kern[3], plain[3])
    acc, tfin, tst, nexec = kern
    gen = torch.Generator(device=device).manual_seed(0)
    gout = torch.randn(acc.shape, generator=gen, device=device)
    gtfin = torch.randn(tfin.shape, generator=gen, device=device)
    dk = cuda_composite.composite_bwd.launch(rec, col, tst, nexec, tfin, gout, gtfin, *tile)
    torch.cuda.synchronize()
    dp = cuda_composite.composite_bwd_plain(rec, col, tst, nexec, tfin, gout, gtfin, *tile)
    grad_close(dk[0], dp[0])
    grad_close(dk[1], dp[1])
    assert (dk[0][:, 6:] == 0).all() and (dk[1][:, 3] == 0).all()


def warp_edge_records(tile, device):
    """One tile of isotropic Gaussians whose 1/255 contour ends at a warp's
    edge pixel: centred beside each warp's pixel rectangle at the contour
    radius, a hair inside and a hair outside, plus opacity-0 padding."""
    th, tw = tile
    pix = cuda_composite.warp_pixels(th, tw)
    px, py = cuda_composite._pixel_basis(th, tw, "cpu")
    rng = np.random.RandomState(2)
    cols = []
    for w in range(pix.shape[0]):
        mine = pix[w][pix[w] >= 0]
        x0, x1, y0, y1 = px[mine].min(), px[mine].max(), py[mine].min(), py[mine].max()
        for f in (1 - 1e-6, 1 + 1e-6):
            o, s = rng.uniform(0.05, 0.95), rng.uniform(0.3, 2.0)
            d = f * np.sqrt(2 * np.log(255 * o)) / s
            xc, yc = rng.uniform(x0, x1), rng.uniform(y0, y1)
            for mx, my in ((x1 + d, yc), (x0 - d, yc), (xc, y1 + d), (xc, y0 - d)):
                cols.append([s, 0.0, -s * mx, s, -s * my, o])
    n = len(cols)
    K = -(-n // 128) * 128 + 128
    rec = torch.zeros(1, 8, K)
    rec[0, :6, :n] = torch.tensor(np.array(cols).T, dtype=torch.float32)
    rec[0, 0, n:] = rec[0, 3, n:] = 1e-6
    col = torch.zeros(1, 4, K)
    col[0, :3, :n] = torch.tensor(rng.uniform(0, 1, (3, n)), dtype=torch.float32)
    return rec.to(device), col.to(device), torch.full((1,), n, dtype=torch.int32, device=device)


@pytest.mark.parametrize("tile", TILES)
def test_footprints_ending_at_warp_edges(cuda, tile):
    rec, col, cnt = warp_edge_records(tile, cuda)
    check_both(rec, col, cnt, tile, cuda)


def test_many_tiles_match_plain(cuda):
    """320 tiles of 8x128 (four blocks each), so that the blocks of a tile
    add their partial gradients into one slice."""
    rng = np.random.RandomState(3)
    shape, n = (320, 1024), 40000
    means = np.stack([rng.uniform(-1.6, 1.6, n), rng.uniform(-0.5, 0.5, n), rng.uniform(2.0, 8.0, n)], -1)
    s = rng.uniform(0.005, 0.04, (n, 3))
    sc = dict(means=means, covariances=np.einsum("ni,ij->nij", s * s, np.eye(3)),
              sh_coeffs=rng.normal(size=(n, 3, 25)) * 0.3, opacities=rng.uniform(0.05, 0.95, n),
              extrinsics=np.eye(4), intrinsics=np.array([[0.8, 0, 0.5], [0, 2.56, 0.5], [0, 0, 1]]),
              near=np.array(1.0), far=np.array(20.0))
    sc = {k: torch.tensor(v, dtype=torch.float32, device=cuda) for k, v in sc.items()}
    pg = projection.project_gaussians(*(sc[k] for k in ARGS), shape)
    b = tiling.bin_gaussians(pg, shape, 32, 256)
    rec, col, cnt = cuda_composite.build_records(pg, b)
    assert rec.shape[0] == 320 and int((cnt > 128).sum()) > 100
    check_both(rec, col, cnt, (8, 128), cuda)


def test_segment_sum_matches_plain(cuda):
    """Float atomics add in an order that changes from run to run: a row of
    n terms is reproducible to (n-1)·2^-24 of the sum of their magnitudes.
    Here n <= 64 (ids drawn from 2000 rows for 60000 entries)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    g, n = 2000, 60000
    ids = torch.randint(0, g + 1, (n,), generator=gen, device=cuda, dtype=torch.int32)
    vals = torch.randn(n, 9, generator=gen, device=cuda)
    launches = segment_sum.scatter_add_rows.launches
    out = segment_sum.scatter_add_rows(ids, vals, g)
    torch.cuda.synchronize()
    assert segment_sum.scatter_add_rows.launches == launches + 1
    ref = segment_sum.scatter_add_rows_plain(ids, vals, g)
    mag = segment_sum.scatter_add_rows_plain(ids, vals.abs(), g)
    n_max = int(torch.bincount(ids.long(), minlength=g + 1)[:g].max())
    assert (out - ref).abs().le((n_max - 1) * 2.0**-24 * mag + 1e-30).all()
    empty = segment_sum.scatter_add_rows(ids[:0], vals[:0], g)
    assert empty.shape == (g, 9) and (empty == 0).all()
    dump = segment_sum.scatter_add_rows(torch.full((5,), g, dtype=torch.int32, device=cuda), vals[:5], g)
    assert (dump == 0).all()


def test_wrapper_rejects_bad_input(cuda):
    rec = torch.zeros(2, 8, 128, device=cuda)
    col = torch.zeros(2, 4, 128, device=cuda)
    with pytest.raises(ValueError):
        cuda_composite.composite_fwd(rec, col, torch.zeros(2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        cuda_composite.composite_fwd(rec, col, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_composite.composite_fwd(rec.transpose(1, 2).contiguous().transpose(1, 2), col,
                                     torch.zeros(2, dtype=torch.int32, device=cuda))
    ok = dict(tst=torch.ones(2, 1024, 1, device=cuda), nexec=torch.ones(2, dtype=torch.int32, device=cuda),
              tfin=torch.ones(2, 1024, 1, device=cuda), gout=torch.ones(2, 1024, 4, device=cuda),
              gtfin=torch.ones(2, 1024, 1, device=cuda))
    cuda_composite.composite_bwd(rec, col, **ok)
    for name, bad in (("nexec", ok["nexec"].long()), ("gout", ok["gout"][:, :, :3]),
                      ("tst", ok["tst"].cpu()), ("gtfin", ok["gtfin"].expand(2, 1024, 1)[:, ::2])):
        with pytest.raises(ValueError):
            cuda_composite.composite_bwd(rec, col, **{**ok, name: bad})
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    vals = torch.zeros(4, 9, device=cuda)
    for bad_ids, bad_vals in ((ids.long(), vals), (ids, vals.double()), (ids[:3], vals),
                              (ids, vals.t().contiguous().t())):
        with pytest.raises(ValueError):
            segment_sum.scatter_add_rows(bad_ids, bad_vals, 10)


@pytest.mark.parametrize("tile", TILES)
def test_binning_and_records_match_cpu(cuda, tile):
    """torch.sort(stable=True) and searchsorted give the same lists on the
    card as on the CPU; records agree to float32 rounding."""
    sc = scene()
    _, b_cpu, r_cpu = records(sc, tile, 512, "cpu")
    _, b_gpu, r_gpu = records(sc, tile, 512, cuda)
    torch.testing.assert_close(b_gpu.counts.cpu(), b_cpu.counts)
    torch.testing.assert_close(b_gpu.gaussian_ids.cpu(), b_cpu.gaussian_ids)
    for a, b in zip(r_gpu, r_cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_render_matches_cpu(cuda):
    sc = scene()

    def both(d):
        e, i, n, f = (sc[k][None].to(d) for k in ("extrinsics", "intrinsics", "near", "far"))
        m, c, s, o = (sc[k][None].to(d) for k in ("means", "covariances", "sh_coeffs", "opacities"))
        rgb = api.render(e, i, n, f, SHAPE, torch.zeros(1, 3, device=d), m, c, s, o, max_per_tile=512)
        depth = api.render_depth(e, i, n, f, SHAPE, m, c, o, max_per_tile=512)
        return rgb, depth

    launches = cuda_composite.composite_fwd.launches
    rgb_g, depth_g = both(cuda)
    assert cuda_composite.composite_fwd.launches == launches + 2
    rgb_c, depth_c = both("cpu")
    image_close(rgb_g, rgb_c)
    image_close(depth_g, depth_c)


@pytest.mark.parametrize("shape,K,padded", [
    ((64, 256), 128, True), ((64, 96), 128, True), ((64, 256), 128, False),
    ((64, 256), None, True), ((64, 96), None, True),
], ids=["ntx2", "ntx1", "ntx2-unpadded", "ntx2-K-at-limit", "ntx1-K-at-limit"])
def test_banked_gather_matches_plain(cuda, shape, K, padded):
    """(ids, counts) bit for bit against banked_lists_plain, at two tiles
    across (window 2x4) and one (window 1x8): on streams that a K of 128
    truncates; on the unpadded streams, whose last windows reach past the
    end (guarded loads in place of bulk copies); at the largest K (None)
    whose shared memory the gate admits."""
    ntx = -(-shape[1] // 128)
    if K is None:
        K = max(k for k in range(128, 8192, 128) if tiling.banked_uses_kernel(20000, ntx, 8, k))
        assert not tiling.banked_uses_kernel(20000, ntx, 8, K + 128)
    sc = scene(n=20000)
    pg = projection.project_gaussians(*(sc[k].to(cuda) for k in ARGS), shape)
    st = tiling.banked_streams(pg, shape, 8, K)
    assert len(st.budgets) == 8 and tiling.banked_uses_kernel(20000, ntx, 8, K)
    if K == 128:
        assert (st.hi - st.lo).max() == 128
    kw = dict(budgets=st.budgets, dydx=st.dydx, qbits=st.qbits, num_tiles=st.num_tiles,
              max_per_tile=K)
    streams = st[:2] if padded else (st.key_sorted[:20000], st.gw_sorted[:20000])
    if not padded:
        last = st.al.long() * 128 + torch.tensor([b + 128 for b in st.budgets], device=cuda)
        assert (last > 20000).any()
    launches = banked_gather.banked_lists.launches
    ids, counts = banked_gather.banked_lists(*streams, *st[2:5], **kw)
    torch.cuda.synchronize()
    assert banked_gather.banked_lists.launches == launches + 1
    ids_p, counts_p = banked_gather.banked_lists_plain(*st[:5], **kw)
    assert torch.equal(ids, ids_p) and torch.equal(counts, counts_p)
    assert int(counts.max()) > 0
    # The lists through the kernel equal the per-slot branch's.
    flat = tiling.bin_gaussians_banked(pg, shape, 8, K, merge="flat")
    sort = tiling.bin_gaussians_banked(pg, shape, 8, K, merge="sort")
    assert torch.equal(flat.gaussian_ids, sort.gaussian_ids) and torch.equal(flat.counts, sort.counts)


def test_banked_render_matches_cpu(cuda):
    """A banked render with the kernel compositor, and its gradients, on
    the card against the CPU path."""
    sc = scene()
    kw = dict(max_per_tile=512, max_dup=8, binning_mode="banked")

    def run(d):
        cams = [sc[k][None].to(d) for k in ("extrinsics", "intrinsics", "near", "far")]
        leaves = [sc[k][None].to(d).requires_grad_(True)
                  for k in ("means", "covariances", "sh_coeffs", "opacities")]
        rgb = api.render(*cams, SHAPE, torch.zeros(1, 3, device=d), *leaves, **kw)
        return rgb, torch.autograd.grad((rgb ** 2).mean(), leaves)

    launches = banked_gather.banked_lists.launches
    rgb_g, grads_g = run(cuda)
    assert banked_gather.banked_lists.launches == launches + 1
    rgb_c, grads_c = run("cpu")
    image_close(rgb_g.detach(), rgb_c.detach())
    for a, b in zip(grads_g, grads_c):
        grad_close(a, b)


def test_banked_gather_rejects_bad_input(cuda):
    sc = scene()
    pg = projection.project_gaussians(*(sc[k].to(cuda) for k in ARGS), SHAPE)
    st = tiling.banked_streams(pg, SHAPE, 8, 128)
    kw = dict(budgets=st.budgets, dydx=st.dydx, qbits=st.qbits, num_tiles=st.num_tiles,
              max_per_tile=128)
    lists = banked_gather.banked_lists
    lists(*st[:5], **kw)
    strided = torch.stack([st.al, st.al], dim=-1)[..., 0]
    for i, bad in ((0, st.key_sorted.long()), (1, st.gw_sorted.cpu()), (2, strided),
                   (3, st.lo.float()), (4, st.hi.t().contiguous().t()),
                   (0, st.key_sorted[1:]), (1, st.gw_sorted[2:])):
        args = list(st[:5])
        args[i] = bad
        if i < 2 and bad.dtype == torch.int32 and bad.is_cuda:   # misaligned start
            args[1 - i] = args[1 - i][:bad.shape[0]]
        with pytest.raises(ValueError):
            lists(*args, **kw)
    with pytest.raises(ValueError):      # over a block's shared memory
        big = tiling._banked_budgets(8192, 2, 8)[0]
        lists(*st[:5], **{**kw, "budgets": big, "max_per_tile": 8192})
    # Streams cut short of the last window: the wrapper checks shapes only
    # (no wait for the card), and the kernel reads every position past the
    # end as no entry: the lists of the full streams with every run cut at n.
    n = 200
    launches = lists.launches
    ids, counts = lists(st.key_sorted[:n], st.gw_sorted[:n], *st[2:5], **kw)
    torch.cuda.synchronize()
    assert lists.launches == launches + 1
    pos = torch.cat([st.al[:, s, None].long() * 128 + torch.arange(b + 128, device=cuda)[None]
                     for s, b in enumerate(st.budgets)], dim=1)
    assert (pos >= n).any()
    cut = torch.clamp(st.hi, max=n)
    ids_p, counts_p = banked_gather.banked_lists_plain(st.key_sorted, st.gw_sorted, st.al,
                                                       torch.clamp(st.lo, max=n), cut, **kw)
    assert torch.equal(ids, ids_p) and torch.equal(counts, counts_p)
    assert int(counts.max()) > 0


def test_banked_binning_waits_for_nothing(cuda):
    """bin_gaussians_banked queues all its work without a host sync (no
    list copied to the card, no read back), so the host can run ahead of
    the card in a raster step."""
    sc = scene()
    pg = projection.project_gaussians(*(sc[k].to(cuda) for k in ARGS), SHAPE)
    first = tiling.bin_gaussians_banked(pg, SHAPE, 8, 128)   # makes the constant rows
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = tiling.bin_gaussians_banked(pg, SHAPE, 8, 128)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(again.gaussian_ids, first.gaussian_ids)


def test_refinement_waits_for_nothing(cuda):
    """The evaluator's test-time refinement queues every Adam step and the
    pick between its two starts without a host sync (no scalar copied to
    the card, no read back), so the host can run ahead of the card."""
    from ggrt_official_torch.config import tiny_config
    from ggrt_official_torch.evaluation.harness import Evaluator

    gen = torch.Generator(device=cuda).manual_seed(0)
    h, w, nv = 32, 64, 3
    tgt = torch.rand(1, 3, h, w, generator=gen, device=cuda)
    refs = torch.rand(nv, 3, h, w, generator=gen, device=cuda)
    inv = 0.2 + 0.3 * torch.rand(1, 1, h, w, generator=gen, device=cuda)
    K = torch.tensor([[[40.0, 0.0, 31.5], [0.0, 40.0, 15.5], [0.0, 0.0, 1.0]]], device=cuda)
    vec0 = 0.02 * torch.randn(nv, 6, generator=gen, device=cuda)
    ev = Evaluator(tiny_config(), None, device=cuda)
    first = ev._refine(vec0, inv, tgt, refs, K, K.expand(nv, 3, 3), steps=3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = ev._refine(vec0, inv, tgt, refs, K, K.expand(nv, 3, 3), steps=3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert again.shape == first.shape == (nv, 6) and torch.isfinite(again).all()


def test_render_waits_for_nothing(cuda):
    """A whole render at the decoder's settings (api.render through
    DecoderSplatting: backend "cuda", sort binning, rgb and depth), forward
    and backward, queues all its work without a host sync after one warm-up
    call (which makes the cached constants): no tensor copied to the card,
    nothing read back."""
    from ggrt_official_torch.config import DecoderCfg
    from ggrt_official_torch.models.decoder_splatting import DecoderSplatting
    from ggrt_official_torch.models.gaussian_adapter import Gaussians

    sc = scene()
    leaves = [sc[k].to(cuda)[None].requires_grad_(True) for k in ARGS[:4]]
    extr, intr = sc["extrinsics"].to(cuda)[None, None], sc["intrinsics"].to(cuda)[None, None]
    near, far = sc["near"].to(cuda).reshape(1, 1), sc["far"].to(cuda).reshape(1, 1)
    decoder = DecoderSplatting(DecoderCfg())
    launches = cuda_composite.composite_fwd.launches

    def step():
        m, c, sh, o = leaves
        g = Gaussians(m, c, sh, o, m, m)
        out = decoder(g, extr, intr, near, far, SHAPE, depth_mode="depth")
        return torch.autograd.grad((out.color ** 2).mean() + out.depth.mean(), leaves)

    first = step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cuda_composite.composite_fwd.launches == launches + 4
    for a, b in zip(again, first):
        grad_close(a, b)


def test_request_waits_for_nothing(cuda):
    """A whole request at pretrain_config() widths (the PixelSplat encoder:
    backbone, epipolar sampler and transformer, depth predictor, Gaussian
    adapter; then the decoder's rgb and depth renders) under
    torch.inference_mode() queues all its work without a host sync after
    one warm-up call, which makes the cached constants."""
    from ggrt_official_torch.config import pretrain_config
    from ggrt_official_torch.data import datasets
    from ggrt_official_torch.data.shims import get_data_shim
    from ggrt_official_torch.models.pixelsplat import PixelSplat
    from ggrt_official_torch.training.trainer import prepare_batch

    cfg = pretrain_config()
    model = PixelSplat(cfg.encoder, cfg.decoder, device=cuda).eval()
    ds = datasets.SyntheticPlanesDataset(datasets.SyntheticSceneSpec(n_views=8, image_size=(64, 96)),
                                         num_source_views=cfg.train.num_source_views)
    batch = prepare_batch(datasets.collate_batch(ds[0]), get_data_shim(cfg.encoder), cuda)
    with torch.inference_mode():
        first, _ = model(batch, 0, deterministic=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again, _ = model(batch, 0, deterministic=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert again["rgb"].shape == (1, 1, 3, 64, 96) and again["depth"].shape == (1, 1, 64, 96)
    image_close(again["rgb"], first["rgb"])


def tiny_trainer(cls, cuda, **train):
    """A trainer of class `cls` at tiny_config() widths with `train`
    settings, built on the card."""
    from ggrt_official_torch.config import apply_overrides, tiny_config

    trainer = cls(apply_overrides(tiny_config(), {f"train.{k}": v for k, v in train.items()}), device=cuda)
    trainer.init_full()
    return trainer


def tiny_example(view=0):
    from ggrt_official_torch.data import datasets

    ds = datasets.SyntheticPlanesDataset(datasets.SyntheticSceneSpec(n_views=8, image_size=(32, 64)),
                                         num_source_views=3)
    return datasets.collate_batch(ds[view])


def test_deferred_bp_is_plain_autograd_on_card(cuda):
    """On the card, with the kernels: at crop_size 1 the finetune step's
    injected pixel gradients give the gradients of plain autograd of
    masked_l2_image_loss on the whole render with the same draws, to
    relative L2 1e-4 per group (float atomics sum in a varying order, so two
    runs of one backward differ in the last bits)."""
    import copy

    from ggrt_official_torch.losses.criterion import masked_l2_image_loss
    from ggrt_official_torch.models.ggrt import GGRtModel
    from ggrt_official_torch.training.trainer import GGRtFinetuneTrainer

    trainer = tiny_trainer(GGRtFinetuneTrainer, cuda, crop_size=1, use_pred_pose=False,
                           **{"optimizer.grad_clip_norm": 0.0})
    start = copy.deepcopy(trainer.model.state_dict())
    ex = tiny_example()
    batch = trainer.prepare_batch(ex)
    u = trainer.draw_uniforms(batch)
    counts = [k.launches for k in (cuda_composite.composite_fwd, cuda_composite.composite_bwd,
                                   segment_sum.scatter_add_rows)]
    trainer.train_iteration(ex, "joint", uniforms=(u, [u]))
    made = [k.launches - c for k, c in zip((cuda_composite.composite_fwd, cuda_composite.composite_bwd,
                                            segment_sum.scatter_add_rows), counts)]
    assert made == [2, 1, 1]

    ref = GGRtModel(trainer.cfg, device=cuda)
    ref.load_state_dict(start)
    min_d, max_d = batch["depth_range"][0, 0], batch["depth_range"][0, 1]
    _, _, sfm, _ = ref.iponet(batch["rgb"], batch["src_rgbs"], batch["camera"], batch["src_cameras"],
                              min_d, max_d)
    ret, gt = ref.gaussian(batch, 0, deterministic=False, uniforms=u, depth_mode=None)
    (sfm["loss"] + masked_l2_image_loss(ret, gt)).backward()

    def flat(module):
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in module.parameters()]).double()

    for group in ("pose_learner", "gaussian"):
        got, want = flat(getattr(trainer.model, group)), flat(getattr(ref, group))
        rel = float((got - want).norm() / want.norm())
        assert want.norm() > 0 and rel <= 1e-4, (group, rel)


def test_cached_step_keeps_detached_entries_on_card(cuda):
    """A cached trainer's entries live on the card, detached, and a second
    step on the same window hits every pair."""
    from ggrt_official_torch.training.trainer_cached import CachedGGRtTrainer

    trainer = tiny_trainer(CachedGGRtTrainer, cuda)
    ex = tiny_example()
    for _ in range(2):
        aux = trainer.train_iteration(ex, "joint")
        assert torch.isfinite(aux["loss_all"])
    assert (trainer.hits, trainer.misses) == (2, 2) and len(trainer.cache) == 2
    for g in trainer.cache.store.values():
        assert all(x.is_cuda and not x.requires_grad for x in g)


def test_train_step_batch_waits_for_nothing(cuda):
    """The loader batch's copies to the card wait for nothing: prepare_batch
    and one 'joint' step under torch's sync debug mode ("warn") raise no
    warning from training/trainer.py::_to_device (each numpy leaf is staged
    in pinned memory and copied with non_blocking=True). The dtypes are the
    loader's."""
    import inspect
    import warnings

    from ggrt_official_torch.training import trainer as trainer_mod

    lines, first = inspect.getsourcelines(trainer_mod._to_device)
    span = range(first, first + len(lines))
    trainer = tiny_trainer(trainer_mod.GGRtTrainer, cuda)
    ex = tiny_example()
    trainer.train_iteration(ex, "joint")          # warm-up: the cached constants
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            batch = trainer.prepare_batch(ex)
            aux = trainer.train_iteration(ex, "joint")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [(w.filename, w.lineno) for w in caught if "synchronizing CUDA operation" in str(w.message)]
    assert not [s for s in syncs if s[0] == trainer_mod.__file__ and s[1] in span], syncs
    assert torch.isfinite(aux["loss_all"])
    assert batch["rgb"].is_cuda and batch["rgb"].dtype == torch.float32
    assert batch["context"]["image"].dtype == torch.float32


def test_video_frame_waits_for_nothing(cuda):
    """render_video's frame path after one warm-up frame: the trajectory and
    one decode up to the uint8 frame on the card, under torch's sync debug
    mode ("error"), at tiny_config() widths; one composite_fwd launch a
    frame; the frame equals the warm-up's at the same camera."""
    from ggrt_official_torch.config import tiny_config
    from ggrt_official_torch.data.shims import get_data_shim
    from ggrt_official_torch.models.decoder_splatting import DecoderSplatting
    from ggrt_official_torch.models.pixelsplat import PixelSplat
    from ggrt_official_torch.scripts.render_video import decode_frame
    from ggrt_official_torch.training.trainer import prepare_batch
    from ggrt_official_torch.utils.trajectories import cosine_ease, interpolate_extrinsics, interpolate_intrinsics

    cfg = tiny_config()
    model = PixelSplat(cfg.encoder, cfg.decoder, device=cuda).eval()
    batch = prepare_batch(tiny_example(), get_data_shim(cfg.encoder), cuda)
    ctx = batch["context"]
    decoder = DecoderSplatting(cfg.decoder)

    def frame():
        t = cosine_ease(4, device=cuda)
        extr = interpolate_extrinsics(ctx["extrinsics"][0, 0], ctx["extrinsics"][0, -1], t)
        intr = interpolate_intrinsics(ctx["intrinsics"][0, 0], ctx["intrinsics"][0, -1], t)
        return decode_frame(decoder, g, extr[1], intr[1], ctx["near"][:, :1], ctx["far"][:, :1], (32, 64))

    with torch.inference_mode():
        g = model.encode_pairs(ctx, 0, deterministic=True)
        first = frame()
        torch.cuda.synchronize()
        launches = cuda_composite.composite_fwd.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = frame()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert cuda_composite.composite_fwd.launches == launches + 1
    assert again.dtype == torch.uint8 and again.shape == (32, 64, 3) and again.is_cuda
    assert int((again.int() - first.int()).abs().max()) <= 1


def test_lpips_on_card_matches_cpu(cuda):
    """The LPIPS network on the card against the same network on the CPU
    (random weights, two image pairs of 320x448 in [-1, 1]): rtol 1e-4, atol
    1e-6 (cuDNN's float32 convolutions sum in another order; TF32 off)."""
    from ggrt_official_torch.evaluation.lpips import LPIPS

    torch.manual_seed(0)
    cpu = LPIPS().eval()
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (1, 1):
                m.weight.uniform_(-0.05, 0.1)
    card = LPIPS().to(cuda).eval()
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    a, b = (torch.rand(2, 3, 320, 448, generator=gen) * 2 - 1 for _ in range(2))
    with torch.no_grad():
        want = cpu(a, b)
        got = card(a.to(cuda), b.to(cuda)).cpu()
    assert got.shape == (2,) and (want > 0).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


# --- the legacy volume-rendering path, BARF and the precision probe ----------

PROBE_BOUND_ULP = {"exp": 2.0, "log": 1.0}


@pytest.mark.parametrize("name", ["exp", "recip", "log"])
def test_probe_kernel_matches_plain(cuda, name):
    """Each probe kernel on the probe's inputs, one launch: within CUDA's
    documented bound of float64 (expf 2 ulp, logf 1 ulp; 1/x correctly
    rounded, so equal to float64's quotient rounded to float32), and within
    twice that of torch's op (which keeps the same bound)."""
    from ggrt_official_torch.tools import diag_exp_precision as probe

    k = probe.KERNELS[name]
    x = probe.probe_inputs(cuda)[name]
    launches = k.launches
    got = k(x)
    torch.cuda.synchronize()
    assert k.launches == launches + 1 and got.is_cuda and got.shape == x.shape
    xs, g, p = (a.cpu().numpy() for a in (x, got, k.plain(x)))
    want = probe.F64[name](xs.astype(np.float64))
    if name == "recip":
        np.testing.assert_array_equal(g, want.astype(np.float32))
        np.testing.assert_array_equal(g, p)
    else:
        assert probe.ulps(g, want).max() <= PROBE_BOUND_ULP[name]
        assert probe.ulps(g, p.astype(np.float64)).max() <= 2 * PROBE_BOUND_ULP[name]


def test_probe_wrapper_rejects_bad_input(cuda):
    """A float64 or strided card tensor is refused before any launch."""
    from ggrt_official_torch.tools import diag_exp_precision as probe

    launches = probe.probe_log.launches
    with pytest.raises(ValueError):
        probe.probe_log(torch.rand(8, 128, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        probe.probe_log(torch.rand(128, 8, device=cuda).T)
    assert probe.probe_log.launches == launches


def legacy_chunk(device):
    """A tiny IBRNetModel (seed 0) and a 256-ray batch of the volume tests'
    scene on `device`, with predicted relative poses."""
    from ggrt_official_torch.config import tiny_config
    from ggrt_official_torch.models.dbarf import IBRNetModel
    from ggrt_official_torch.rendering.rays import get_rays_single_image

    rng = np.random.RandomState(0)
    h, w, v = 24, 32, 3

    def camera(c2w):
        K = np.eye(4)
        K[:3, :3] = [[30.0, 0, w / 2], [0, 33.0, h / 2], [0, 0, 1]]
        return np.concatenate([[h, w], K.ravel(), c2w.ravel()]).astype(np.float32)

    def pose():
        c2w = np.eye(4)
        c2w[:3, 3] = rng.uniform(-0.3, 0.3, 3) * [1, 1, 0.2]
        return c2w

    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    model = IBRNetModel(tiny_config(), coarse_feat_dim=8, n_samples=16, device=device).eval()
    query, src = camera(pose()), np.stack([camera(pose()) for _ in range(v)])
    ro, rd = get_rays_single_image(h, w, t(query[2:18]).reshape(1, 4, 4), t(query[18:34]).reshape(1, 4, 4))
    src_rgbs = t(rng.uniform(size=(v, h, w, 3)))
    batch = {"ray_o": ro[:256], "ray_d": rd[:256], "depth_range": t([1.5, 6.0]), "camera": t(query),
             "src_rgbs": src_rgbs, "src_cameras": t(src)}
    rel = t(rng.normal(size=(v, 6)) * 0.03)
    return model, batch, rel


def test_render_rays_chunk_waits_for_nothing(cuda):
    """A chunk of render_rays with relative poses (the feature net, the
    projection with its pose inverses, the gathers, IBRNet, compositing)
    queues all its work without a host sync, after one warm-up call. In
    float64 the card's chunk equals the CPU's to 1e-9 (rgb, depth), the
    card's feature maps given to both. In float32 they differ by far more
    than rounding (atol 2e-2 in rgb and 1% of the far plane, 6e-2, in
    depth here): IBRNet's anti-alias weights are differences of
    exp values that agree to ~1e-5 where the source views see a sample
    from nearly one direction, so one ulp of exp moves a weight by ~1%, and
    the card's expf keeps 2 ulp (1.82 measured by the probe) where the
    CPU's keeps ~0.5."""
    import copy

    from ggrt_official_torch.rendering import volume

    model, batch, rel = legacy_chunk(cuda)

    def run(m, b, r, feats=None):
        feats = m.extract_features(b["src_rgbs"])[0] if feats is None else feats
        return volume.render_rays(b, m.coarse, (feats, None), 16, inv_uniform=True, det=True,
                                  rel_poses=r)["outputs_coarse"]

    def as64(m, b, r, feats):
        return copy.deepcopy(m).double(), {k: v.double() for k, v in b.items()}, r.double(), feats.double()

    with torch.inference_mode():
        first = run(model, batch, rel)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = run(model, batch, rel)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        feats = model.extract_features(batch["src_rgbs"])[0]
        cpu_model, cpu_batch, cpu_rel = legacy_chunk("cpu")
        want32 = run(cpu_model, cpu_batch, cpu_rel, feats.cpu())
        card64 = run(*as64(model, batch, rel, feats))
        cpu64 = run(*as64(cpu_model, cpu_batch, cpu_rel, feats.cpu()))
    assert torch.equal(again["rgb"], first["rgb"])
    for k in ("rgb", "depth"):
        torch.testing.assert_close(card64[k].cpu(), cpu64[k], rtol=1e-9, atol=1e-9)
        torch.testing.assert_close(again[k].cpu(), want32[k], rtol=0, atol={"rgb": 2e-2, "depth": 6e-2}[k])


def test_barf_train_step_waits_for_nothing(cuda):
    """A BARFTrainer step (the draws, the corrected pose, the annealed
    field, Adam on both groups) queues all its work without a host sync
    after one warm-up step; its loss stays a tensor on the card."""
    from ggrt_official_torch.training.barf_trainer import BARFTrainConfig, BARFTrainer

    tr = BARFTrainer(BARFTrainConfig(num_cameras=2, depth=4, width=32, num_freqs_xyz=4, n_samples=16), device=cuda)
    tr.init()
    gen = torch.Generator().manual_seed(0)
    d = torch.randn(64, 3, generator=gen) * torch.tensor([0.3, 0.3, 0.0]) + torch.tensor([0.0, 0.0, 1.0])
    batch = {"rays_o": torch.zeros(64, 3), "rays_d": d / d.norm(dim=-1, keepdim=True),
             "rgb": torch.rand(64, 3, generator=gen), "cam_idx": torch.tensor(1), "base_c2w": torch.eye(4)}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    tr.train_step(batch, 0, 10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = tr.train_step(batch, 3, 10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert loss.is_cuda and loss.dim() == 0 and torch.isfinite(loss)
    assert float(tr.model.pose_refine[1].abs().max()) > 0 and float(tr.model.pose_refine[0].abs().max()) == 0


def test_resunet_on_card_matches_cpu(cuda):
    """ResUNet (coarse and fine maps) on the card against the CPU, same
    weights, 2 images of 36x52: rtol 1e-4, atol 1e-4 (cuDNN's float32
    convolutions sum in another order; TF32 off)."""
    from ggrt_official_torch.models.feature_unet import ResUNet
    from ggrt_official_torch.weights import init_flax_defaults

    cpu = ResUNet(coarse_out_ch=8, fine_out_ch=4)
    init_flax_defaults(cpu, torch.Generator().manual_seed(0))
    card = ResUNet(coarse_out_ch=8, fine_out_ch=4).to(cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(2, 36, 52, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = cpu(x)
        got = card(x.to(cuda))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_cuda
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


def full_width_request(cuda):
    """A GGRtModel at pretrain_config() widths on the card and a prepared
    64x96 request with 5 source views."""
    from ggrt_official_torch.config import pretrain_config
    from ggrt_official_torch.data import datasets
    from ggrt_official_torch.data.shims import get_data_shim
    from ggrt_official_torch.models.ggrt import GGRtModel
    from ggrt_official_torch.training.trainer import prepare_batch

    cfg = pretrain_config()
    model = GGRtModel(cfg, device=cuda).eval()
    ds = datasets.SyntheticPlanesDataset(datasets.SyntheticSceneSpec(n_views=8, image_size=(64, 96)),
                                         num_source_views=cfg.train.num_source_views)
    return model, prepare_batch(datasets.collate_batch(ds[0]), get_data_shim(cfg.encoder), cuda)


def test_request_with_capture_off_waits_for_nothing(cuda):
    """After the encoder's capture taps were on and off again, a whole
    full-width request queues all its work without a host sync (the taps
    cost one attribute test while off), and renders what it rendered with
    them on, bit for bit."""
    from ggrt_official_torch.utils.encoder_visualizer import capture_intermediates

    model, batch = full_width_request(cuda)
    with torch.inference_mode():
        with capture_intermediates(model.gaussian) as taps:
            on, _ = model.gaussian(batch, 0, deterministic=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            off, _ = model.gaussian(batch, 0, deterministic=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert taps["attn"] and taps["depth_pdf"] and all(x.is_cuda for x in taps["attn"])
    assert torch.equal(on["rgb"], off["rgb"])


def test_dump_rgb_is_a_plain_request(cuda, tmp_path):
    """dump_encoder_visualizations on the card at pretrain_config() widths:
    its rendered_rgb is a plain request's rgb bit for bit, its images are
    finite, and it writes its PNGs."""
    from ggrt_official_torch.utils.encoder_visualizer import dump_encoder_visualizations

    model, batch = full_width_request(cuda)
    with torch.inference_mode():
        plain, _ = model.gaussian(batch, 0, deterministic=True)
    dumps = dump_encoder_visualizations(model, batch, 0, (64, 96), out_dir=str(tmp_path))
    np.testing.assert_array_equal(dumps["rendered_rgb"], plain["rgb"].cpu().numpy())
    assert any(k.startswith("attention_") for k in dumps) and any(k.startswith("depth_pdf_") for k in dumps)
    assert all(np.isfinite(v).all() for v in dumps.values())
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(f"{k}.png" for k in dumps)


def test_visualization_on_card_matches_cpu(cuda):
    """apply_color_map, draw_lines, hcat and add_label on card tensors stay
    on the card and equal the same calls on the CPU within 1e-6."""
    from ggrt_official_torch.visualization import add_label, apply_color_map, draw_lines, hcat

    gen = torch.Generator().manual_seed(0)
    depth, img = torch.rand(40, 56, generator=gen), torch.rand(3, 40, 56, generator=gen)
    start, end = torch.rand(6, 2, generator=gen) * 56, torch.rand(6, 2, generator=gen) * 40
    for fn in (lambda d, i: apply_color_map(d, "turbo"), lambda d, i: draw_lines(i, start, end, (1.0, 0.2, 0.1), 2.0),
               lambda d, i: hcat(i, d[None].expand(3, -1, -1)), lambda d, i: add_label(i, "card")):
        got, want = fn(depth.to(cuda), img.to(cuda)), fn(depth, img)
        assert got.is_cuda and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)


def test_tile_parallel_render_matches_api_render(cuda, tmp_path):
    """render_tile_parallel, "cuda", at world size 1 (NCCL, a file://
    store): the image equals api.render's with the same options, the means'
    gradient agrees, and one step launches (fwd, bwd, scatter) once each."""
    import datetime

    import torch.distributed as dist

    from ggrt_official_torch.parallel import make_mesh
    from ggrt_official_torch.parallel.tile_parallel import render_tile_parallel

    sc = {k: v.to(cuda) for k, v in scene().items()}
    kw = dict(max_dup=8, max_per_tile=512)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh()
        means = sc["means"].clone().requires_grad_(True)
        kernels = (cuda_composite.composite_fwd, cuda_composite.composite_bwd, segment_sum.scatter_add_rows)
        before = [k.launches for k in kernels]
        img = render_tile_parallel(mesh, means, *(sc[k] for k in ARGS[1:]), SHAPE,
                                   torch.zeros(3, device=cuda), backend="cuda", **kw)
        (grad,) = torch.autograd.grad((img ** 2).mean(), means)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1]
    finally:
        dist.destroy_process_group()
    ref_means = sc["means"][None].clone().requires_grad_(True)
    ref = api.render(*(sc[k][None] for k in ARGS[4:]), SHAPE, torch.zeros(1, 3, device=cuda), ref_means,
                     *(sc[k][None] for k in ARGS[1:4]), backend="cuda", **kw)
    (ref_grad,) = torch.autograd.grad((ref ** 2).mean(), ref_means)
    assert torch.equal(img.detach(), ref[0].detach())
    scale = float(ref_grad.abs().max())
    assert scale > 0 and float((grad - ref_grad[0]).abs().max()) <= 1e-4 * scale


def test_bench_measure_at_64x128(cuda, monkeypatch):
    """scripts.bench.measure at 64x128 (both scales): the gate holds, the
    line's numbers are the card's, every raster step launches (fwd, bwd,
    scatter) once each and the banked gather where its gate admits K."""
    from ggrt_official_torch.scripts import bench

    monkeypatch.setattr(bench, "HEADLINE", ((64, 128), 2))
    monkeypatch.setattr(bench, "WAYMO", ((64, 128), 1))
    kernels = (cuda_composite.composite_fwd, cuda_composite.composite_bwd, segment_sum.scatter_add_rows,
               banked_gather.banked_lists)
    made, raster_step = [], bench.raster_step

    def counted(*args, **kwargs):
        step = raster_step(*args, **kwargs)

        def run():
            before = [k.launches for k in kernels]
            out = step()
            made.append([k.launches - b for k, b in zip(kernels, before)])
            return out

        return run

    monkeypatch.setattr(bench, "raster_step", counted)
    line = bench.measure("cuda")
    d = line["detail"]
    assert line["value"] > 0 and d["step_ms"] > 0 and d["device"] == torch.cuda.get_device_name(0)
    assert d["pallas_vs_xla_mean_err"] < bench.GATE_MEAN and d["n_gaussians"] == 64 * 128 * 6
    assert d["waymo_640x960"]["pixels_per_s"] > 0
    # The banked kernel serves the lists where its gate admits this K on a
    # one-tile-wide image; else the per-slot merge runs.
    K = d["cap_policy"]["max_per_tile"]
    gather = int(tiling.banked_uses_kernel(d["n_gaussians"], 1, 8, K))
    assert made and all(m == [1, 1, 1, gather] for m in made), (made, K)
