"""Card-only tests of the port: the CUDA compositor kernel against its plain
PyTorch version, and the rasterizer on the card against the same code on
the CPU. Every test here needs a CUDA card and skips without one.

A card-only environment need not have JAX, and tests/conftest.py imports
it, so run this file without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from ggrt_official_torch.ops.rasterizer import api, cuda_composite, projection, tiling

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
    # The kernel stops a pixel for good (CUDA semantics); the plain version
    # keeps the reference's per-chunk rule, so it never runs fewer chunks.
    assert (kern[3] <= plain[3]).all()
    assert (kern[3][cnt == 0] == 0).all()


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
