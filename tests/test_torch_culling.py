"""The compositor kernels' footprint culling, held on the CPU.

The CUDA kernels (csrc/composite_fwd.cu, composite_bwd.cu) let each warp
skip the Gaussians whose widened footprint box misses the warp's pixels
(csrc/composite_cull.cuh). `cuda_composite.warp_keeps_plain` is that test on
tensors. It must be conservative: every (pixel, Gaussian) pair that
`composite_records_plain`'s arithmetic gives alpha >= 1/255 lies in a kept
(warp, Gaussian) pair, at every tile shape, under the kernels' thread map.
The kernels themselves are held against the plain versions on the card by
tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

from ggrt_official_torch.ops.rasterizer import cuda_composite as cc
from ggrt_official_torch.ops.rasterizer import projection, tiling

TILES = [(8, 128), (16, 16), (8, 32), (8, 16)]
ALPHA_MIN32 = float(np.float32(1.0 / 255.0))


def live_pairs(records, tile_h, tile_w):
    """(t, P, K) bool: araw >= 1/255 in composite_records_plain's float32
    arithmetic."""
    px, py = cc._pixel_basis(tile_h, tile_w, records.device)
    px, py = px[None, :, None], py[None, :, None]
    B = records
    u = px * B[:, 0:1] + py * B[:, 1:2] + B[:, 2:3]
    v = py * B[:, 3:4] + B[:, 4:5]
    araw = B[:, 5:6] * torch.exp(-0.5 * (u * u + v * v))
    return araw >= cc.ALPHA_MIN


def assert_covered(records, tile_h, tile_w):
    """Every live pair lies in a kept (warp, Gaussian) pair; returns the
    number of live pairs."""
    live = live_pairs(records, tile_h, tile_w)                 # (t, P, K)
    keep = cc.warp_keeps_plain(records, tile_h, tile_w)        # (t, W, K)
    pix = cc.warp_pixels(tile_h, tile_w)
    warp_of = torch.empty(tile_h * tile_w, dtype=torch.long)
    w_idx = torch.arange(pix.shape[0])[:, None].expand_as(pix)
    warp_of[pix[pix >= 0]] = w_idx[pix >= 0]
    kept_at_pixel = keep[:, warp_of, :]                         # (t, P, K)
    missed = live & ~kept_at_pixel
    assert not missed.any(), f"{int(missed.sum())} live pairs in culled (warp, Gaussian) pairs"
    return int(live.sum())


def cholesky_records(mx, my, conic, opacity):
    """Records (1, 8, n) from tile-centred means, conics (n, 3) = (a, b, c)
    and opacities, as build_records forms them."""
    mx, my, opacity = (torch.tensor(np.asarray(x), dtype=torch.float32) for x in (mx, my, opacity))
    conic = torch.tensor(np.asarray(conic), dtype=torch.float32)
    ca, cb, ccc = conic[:, 0], conic[:, 1], conic[:, 2]
    l00 = torch.sqrt(torch.clamp(ca, min=1e-12))
    l01 = cb / l00
    l11 = torch.sqrt(torch.clamp(ccc - l01 * l01, min=1e-12))
    cu = -(l00 * mx + l01 * my)
    cv = -l11 * my
    z = torch.zeros_like(l00)
    return torch.stack([l00, l01, cu, l11, cv, opacity, z, z])[None]


def hard_records(tile_h, tile_w, seed=0):
    """One tile's records (1, 8, K) made to sit on the test's edges:
    footprints whose 1/255 contour just reaches (or just misses) a warp's
    edge pixel, elongated ellipses (large |l01|), opacity just above and at
    1/255, and opacity-0 padding."""
    rng = np.random.RandomState(seed)
    pix = cc.warp_pixels(tile_h, tile_w)
    px, py = cc._pixel_basis(tile_h, tile_w, "cpu")
    mx, my, conic, op = [], [], [], []
    # Isotropic footprints centred beside each warp's rectangle, their
    # 1/255 contour within a hair of its edge pixel, on both sides of it.
    for w in range(pix.shape[0]):
        mine = pix[w][pix[w] >= 0]
        x0, x1 = float(px[mine].min()), float(px[mine].max())
        y0, y1 = float(py[mine].min()), float(py[mine].max())
        for _ in range(2):
            o = rng.uniform(0.02, 0.99)
            s = rng.uniform(0.2, 3.0)                  # l00 = l11 = s
            r = np.sqrt(2.0 * np.log(255.0 * o)) / s  # contour radius in pixels
            for f in (1.0 - 1e-6, 1.0 + 1e-6):
                d = r * f
                yc = rng.uniform(y0, y1)
                xc = rng.uniform(x0, x1)
                for cx, cy in ((x1 + d, yc), (x0 - d, yc), (xc, y1 + d), (xc, y0 - d)):
                    mx.append(cx)
                    my.append(cy)
                    conic.append((s * s, 0.0, s * s))
                    op.append(o)
    # Elongated ellipses at random angles: axes 0.3-2 by 20-200 pixels.
    for _ in range(96):
        th = rng.uniform(0, np.pi)
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        cov = R @ np.diag([rng.uniform(0.3, 2.0), rng.uniform(20.0, 200.0)]) ** 2 @ R.T
        inv = np.linalg.inv(cov)
        conic.append((inv[0, 0], inv[0, 1], inv[1, 1]))
        mx.append(rng.uniform(-tile_w, tile_w))
        my.append(rng.uniform(-tile_h * 8, tile_h * 8))
        op.append(rng.uniform(0.01, 0.99))
    # Opacity just above 1/255 and at it, on and off pixel centres.
    a = np.float32(1.0 / 255.0)
    for o in (a, np.nextafter(a, np.float32(1)), np.nextafter(np.nextafter(a, np.float32(1)), np.float32(1))):
        for _ in range(8):
            mx.append(float(px[rng.randint(len(px))]) + rng.choice([0.0, 0.5, 0.01]))
            my.append(float(py[rng.randint(len(py))]) + rng.choice([0.0, 0.5, 0.01]))
            s = rng.uniform(0.05, 2.0)
            conic.append((s * s, 0.0, s * s))
            op.append(float(o))
    n = len(op)
    K = -(-n // 128) * 128 + 128                       # at least one chunk of padding
    rec = cholesky_records(mx, my, conic, op)
    rec = torch.nn.functional.pad(rec, (0, K - n))     # opacity-0 padding
    rec[:, 0, n:] = rec[:, 3, n:] = 1e-6               # as build_records clamps them
    return rec


def scene_records(tile, K=256, n=3000, seed=0):
    """Records of a random scene (numpy seed) binned at `tile`, with a
    quarter of the tiles given count 0 and their lists emptied."""
    rng = np.random.RandomState(seed)
    shape = (64, 256)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-0.5, 0.5, n), rng.uniform(2.0, 8.0, n)], -1)
    s = rng.uniform(0.01, 0.08, (n, 3))
    args = [torch.tensor(x, dtype=torch.float32) for x in (
        means, np.einsum("ni,ij->nij", s * s, np.eye(3)), rng.normal(size=(n, 3, 25)) * 0.3,
        rng.uniform(0.05, 0.95, n), np.eye(4), np.array([[0.8, 0, 0.5], [0, 3.2, 0.5], [0, 0, 1]]),
        np.array(1.0), np.array(20.0))]
    pg = projection.project_gaussians(*args, shape)
    b = tiling.bin_gaussians(pg, shape, 32, K, *tile)
    counts = b.counts.clone()
    counts[::4] = 0
    keep = torch.arange(K)[None] < counts[:, None]
    b = b._replace(counts=counts, gaussian_ids=torch.where(keep, b.gaussian_ids, -1))
    return cc.build_records(pg, b, *tile)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_kept_pairs_cover_live_pairs(tile, seed):
    rec = hard_records(*tile, seed)
    assert assert_covered(rec, *tile) > 0


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_kept_pairs_cover_scene_pairs(tile):
    rec, _, counts = scene_records(tile)
    assert (counts == 0).any() and (counts > 128).any()
    assert assert_covered(rec, *tile) > 0


@pytest.mark.parametrize("tile", TILES + [(3, 5), (1, 1024), (32, 32), (5, 200)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_warp_pixels_cover_tile_once(tile):
    th, tw = tile
    pix = cc.warp_pixels(th, tw)
    assert pix.shape[1] == 32
    # Every warp holds a pixel, every pixel sits in one lane.
    assert (pix >= 0).any(dim=1).all()
    assert torch.equal(torch.sort(pix[pix >= 0]).values, torch.arange(th * tw))
    # Each warp holds a patch of at most pw x ph pixels, ph = min(8, the
    # largest power of two <= th): 4 columns x 8 rows of an 8x128 tile.
    ph = 8 if th >= 8 else 1 << (th.bit_length() - 1)
    for lanes in pix:
        x, y = lanes[lanes >= 0] % tw, lanes[lanes >= 0] // tw
        assert int(x.max() - x.min()) + 1 <= 32 // ph and int(y.max() - y.min()) + 1 <= ph
    if tile == (8, 128):
        x, y = pix[0] % tw, pix[0] // tw
        assert (int(x.max() - x.min()) + 1, int(y.max() - y.min()) + 1) == (4, 8)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_footprint_box_drops_only_what_no_pixel_takes(tile):
    """Empty boxes for opacity below 1/255 or NaN and for non-finite
    geometry; opacity exactly 1/255 reaches the pixel under its mean and is
    kept there; opacity +inf (alpha clamped to 0.99) is kept everywhere."""
    rec = cholesky_records([0.5] * 8, [0.5] * 8, [(1.0, 0.0, 1.0)] * 8, [0.5] * 8)
    nan, inf = float("nan"), float("inf")
    rec[0, 5, 0] = float(np.nextafter(np.float32(ALPHA_MIN32), np.float32(0)))
    rec[0, 5, 1] = nan
    rec[0, 0, 2] = inf
    rec[0, 2, 3] = nan
    rec[0, 4, 4] = -inf
    rec[0, 5, 5] = ALPHA_MIN32
    rec[0, 5, 6] = inf
    th, tw = tile
    box = cc.footprint_boxes(rec, th, tw)[0]
    empty = torch.isinf(box[0]) & (box[0] > 0)
    assert empty.tolist() == [True] * 5 + [False] * 3
    assert torch.isinf(box[:, 6]).all() and box[0, 6] < 0
    live = live_pairs(rec, th, tw)[0]
    assert not live[:, :5].any() and live[:, 6].any()
    # Only the pixel at tile-centred (0.5, 0.5) takes opacity 1/255.
    assert live[th // 2 * tw + tw // 2, 5] and int(live[:, 5].sum()) == 1
    assert_covered(rec, th, tw)
    keep = cc.warp_keeps_plain(rec, th, tw)[0]
    assert keep[:, 6].all() and not keep[:, :5].any()
    # Its box, one pixel wide about that pixel, meets at most 2 x 2 warps.
    assert int(keep[:, 5].sum()) <= min(4, keep.shape[0] - 1)


def test_kept_share_is_small_on_pixel_scale_scene():
    """bench.py's population (pixel-scale isotropic Gaussians, 6 per pixel)
    at 32x448: most (warp, Gaussian) pairs are culled."""
    rng = np.random.RandomState(0)
    h, w = 32, 448
    n = h * w * 6
    means = np.stack([rng.uniform(-2.0, 2.0, n), rng.uniform(-1.5 * h / w, 1.5 * h / w, n),
                      rng.uniform(1.2, 8.0, n)], -1)
    s = rng.uniform(0.002, 0.02, (n, 3))
    args = [torch.tensor(x, dtype=torch.float32) for x in (
        means, np.einsum("ni,ij->nij", s * s, np.eye(3)), np.zeros((n, 3, 25)),
        rng.uniform(0.05, 0.9, n), np.eye(4), np.array([[1.2, 0, 0.5], [0, 1.2 * w / h, 0.5], [0, 0, 1]]),
        np.array(1.0), np.array(20.0))]
    pg = projection.project_gaussians(*args, (h, w))
    b = tiling.bin_gaussians(pg, (h, w), 8, 512)
    rec, _, counts = cc.build_records(pg, b)
    assert int(counts.min()) > 128
    keep = cc.warp_keeps_plain(rec, 8, 128)
    live = rec[:, 5, :] > 0                                              # listed entries
    share = (keep & live[:, None, :]).sum().item() / (live.sum().item() * keep.shape[1])
    assert 0.0 < share < 0.4, share
    assert_covered(rec, 8, 128)
