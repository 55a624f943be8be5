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
