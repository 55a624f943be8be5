"""Card-only tests of the port: the CUDA kernels (forward and backward
compositor, segment-sum scatter) against their plain PyTorch versions, and
the rasterizer on the card against the same code on the CPU. Every test
here needs a CUDA card and skips without one.

A card-only environment need not have JAX, and tests/conftest.py imports
it, so run this file without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from ggrt_official_torch.ops.rasterizer import api, cuda_composite, projection, segment_sum, tiling

pytestmark = pytest.mark.gpu

SHAPE = (64, 256)
TILES = [(8, 128), (16, 16)]


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
