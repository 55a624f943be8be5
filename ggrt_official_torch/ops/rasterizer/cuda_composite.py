"""Per-tile alpha compositing: record build, the Hopper kernels' wrappers,
their plain PyTorch versions, the autograd functions and the image assembly.

Records are component-major (tiles, 8, K) and hold the Cholesky factor of
each Gaussian's conic with its tile-local mean folded into linear
coefficients: rows [l00, l01, cu, l11, cv, opacity, 0, 0], so that
u = l00·x + l01·y + cu and v = l11·y + cv are whitened screen offsets and
alpha = opacity·exp(-(u² + v²)/2). K is padded to a multiple of 128, the
compositor's chunk.

`composite_fwd` and `composite_bwd` launch the CUDA kernels
(csrc/composite_fwd.cu, csrc/composite_bwd.cu) for CUDA tensors and run
`composite_records_plain` / `composite_bwd_plain` for CPU tensors; on any
other device they raise. They never fall back from a kernel to a plain
version. The kernels give each warp of a tile a patch of pixels (the thread
map, `warp_pixels`) and let it skip the Gaussians whose widened footprint
box misses its pixels (csrc/composite_cull.cuh); `warp_keeps_plain` is that
test on tensors. `CompositeCore` and `GatherRows` are the autograd
functions of the JAX package's `_get_composite_core` and `_gather_rows`:
the compositor's backward is the backward kernel, the gather's is the
segment-sum kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...constants import device_constant
from ...utils.tracing import span
from ..cuda_kernel import INT, PTR, CudaKernel, check_tensors
from .projection import ALPHA_MAX, ALPHA_MIN, T_EPS, ProjectedGaussians
from .segment_sum import scatter_add_rows
from .tiling import TILE_H, TILE_W, TileBinning

CHUNK = 128                  # Gaussians per compositor chunk
MAX_TILE_PIXELS = 1024       # the kernels run one thread per tile pixel
REL_SLACK = 2.0 ** -16       # the footprint box's relative widening


class GatherRows(torch.autograd.Function):
    """comp[max(ids, 0)]; the pullback scatter-adds the live rows only, with
    dead ids (< 0) sent to the dump row g, which the scatter drops."""

    @staticmethod
    def forward(ctx, comp, ids):
        ctx.save_for_backward(ids)
        ctx.g = comp.shape[0]
        return comp[ids.clamp(min=0)]

    @staticmethod
    def backward(ctx, dgath):
        (ids,) = ctx.saved_tensors
        g = ctx.g
        idx = torch.where(ids >= 0, ids, g).reshape(-1).to(torch.int32)
        dcomp = scatter_add_rows(idx, dgath.reshape(idx.shape[0], -1).contiguous(), g)
        return dcomp, None


def build_records(pg: ProjectedGaussians, binning: TileBinning,
                  tile_h: int = TILE_H, tile_w: int = TILE_W):
    """Gather per-tile Gaussian lists into component-major records.

    Returns records (t, 8, K_pad), colors (t, 4, K_pad) float32 and the
    list lengths (t,) int32.
    """
    nty, ntx = binning.num_tiles_y, binning.num_tiles_x
    num_tiles = nty * ntx
    ids = binning.gaussian_ids
    K0 = ids.shape[1]
    K_pad = max(CHUNK, -(-K0 // CHUNK) * CHUNK)

    comp = torch.cat(
        [pg.mean2d, pg.conic, pg.color, pg.opacity[:, None]], dim=-1
    )  # (g, 9)
    gath = GatherRows.apply(comp, ids)  # (t, K0, 9)
    if K_pad != K0:
        ids = F.pad(ids, (0, K_pad - K0), value=-1)
        gath = F.pad(gath, (0, 0, 0, K_pad - K0))
    present = (ids >= 0).to(gath.dtype)
    mean2d = gath[..., 0:2]
    conic = gath[..., 2:5]
    color = gath[..., 5:8]
    opacity = gath[..., 8] * present

    t_idx = torch.arange(num_tiles, dtype=torch.float32, device=ids.device)
    ox = (t_idx % ntx) * tile_w + (tile_w - 1) / 2.0
    oy = torch.div(t_idx, ntx, rounding_mode="floor") * tile_h + (tile_h - 1) / 2.0
    mx = mean2d[..., 0] - ox[:, None]
    my = mean2d[..., 1] - oy[:, None]

    ca, cb, cc = conic[..., 0], conic[..., 1], conic[..., 2]
    # Cholesky of the conic [[ca, cb], [cb, cc]]; padded or culled entries
    # are clamped to keep sqrt finite — opacity 0 puts them below 1/255.
    l00 = torch.sqrt(torch.clamp(ca, min=1e-12))
    l01 = cb / l00
    l11 = torch.sqrt(torch.clamp(cc - l01 * l01, min=1e-12))
    cu = -(l00 * mx + l01 * my)
    cv = -l11 * my

    zeros = torch.zeros_like(ca)
    records = torch.stack([l00, l01, cu, l11, cv, opacity, zeros, zeros], dim=1)
    colors = torch.stack([color[..., 0], color[..., 1], color[..., 2], zeros], dim=1)
    return records.contiguous(), colors.contiguous(), binning.counts.to(torch.int32)


def _pixel_basis(tile_h: int, tile_w: int, device):
    """Tile-centred pixel coordinates (x, y), each (P,)."""
    p = torch.arange(tile_h * tile_w, device=device)
    px = (p % tile_w).to(torch.float32) - (tile_w - 1) / 2.0
    py = torch.div(p, tile_w, rounding_mode="floor").to(torch.float32) - (tile_h - 1) / 2.0
    return px, py


def warp_pixels(tile_h: int, tile_w: int) -> torch.Tensor:
    """(warps, 32) int64: the tile pixel (row-major index) of each lane of
    each warp under the kernels' thread map (composite_cull.cuh), -1 where a
    lane has none. Warp w takes a pw x ph patch, ph = 8 or the largest
    power of two <= tile_h and pw = 32 / ph; patches are row-major."""
    ph = 8 if tile_h >= 8 else 4 if tile_h >= 4 else 2 if tile_h >= 2 else 1
    pw = 32 // ph
    npx, npy = -(-tile_w // pw), -(-tile_h // ph)
    w = torch.arange(npx * npy)[:, None]
    lane = torch.arange(32)[None]
    x = (w % npx) * pw + lane % pw
    y = torch.div(w, npx, rounding_mode="floor") * ph + torch.div(lane, pw, rounding_mode="floor")
    return torch.where((x < tile_w) & (y < tile_h), y * tile_w + x, -1)


def footprint_boxes(records: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """(t, 4, K) float32: the kernels' widened footprint box (xlo, xhi, ylo,
    yhi) of every record in tile-centred pixels, empty (+inf, -inf, +inf,
    -inf) where the record can reach alpha >= 1/255 at no pixel
    (composite_cull.cuh::footprint_box, in the same float32 arithmetic)."""
    l00, l01, cu, l11, cv, op = (records[:, i] for i in range(6))
    ext_x, ext_y = (tile_w - 1) / 2.0, (tile_h - 1) / 2.0
    with torch.no_grad():
        r = torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * op), min=0.0))
        R = r + 4e-3 * (r + 1.0) + 1e-6 * (l00.abs() * ext_x + l01.abs() * ext_y + cu.abs()
                                           + l11.abs() * ext_y + cv.abs())
        iy = 1.0 / l11
        my = -cv * iy
        a = l01 * iy
        mx = -(cu + l01 * my) / l00
        hx0 = R * torch.sqrt(1.0 + a * a) / l00.abs()
        hy0 = R * iy.abs()
        hx = hx0 + 1.0 + REL_SLACK * (mx.abs() + hx0 + (cu.abs() + (l01 * my).abs()) / l00.abs())
        hy = hy0 + 1.0 + REL_SLACK * (my.abs() + hy0)
        box = torch.stack([mx - hx, mx + hx, my - hy, my + hy], dim=1)
        finite = torch.isfinite(records[:, :5]).all(dim=1)
        live = (op >= ALPHA_MIN) & finite                     # False for NaN opacity
        none = device_constant((float("inf"), -float("inf")) * 2, torch.float32, records.device)
        return torch.where(live[:, None], box, none[None, :, None])


def warp_keeps_plain(records: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """The kernels' culling test on tensors: (t, warps, K) bool, True where
    warp w keeps Gaussian k, i.e. where k's footprint box meets the
    rectangle of w's pixels. A NaN in the box keeps the Gaussian."""
    pix = warp_pixels(tile_h, tile_w).to(records.device)
    px, py = _pixel_basis(tile_h, tile_w, records.device)
    has = pix >= 0
    inf = device_constant(float("inf"), torch.float32, records.device)
    xs, ys = px[pix.clamp(min=0)], py[pix.clamp(min=0)]
    x0 = torch.where(has, xs, inf).amin(1)[None, :, None]   # (1, W, 1)
    x1 = torch.where(has, xs, -inf).amax(1)[None, :, None]
    y0 = torch.where(has, ys, inf).amin(1)[None, :, None]
    y1 = torch.where(has, ys, -inf).amax(1)[None, :, None]
    box = footprint_boxes(records, tile_h, tile_w)[:, :, None, :]  # (t, 4, 1, K)
    miss = (box[:, 0] > x1) | (box[:, 1] < x0) | (box[:, 2] > y1) | (box[:, 3] < y0)
    return ~miss


def composite_records_plain(records: torch.Tensor, colors: torch.Tensor,
                            counts: torch.Tensor, tile_h: int = TILE_H,
                            tile_w: int = TILE_W):
    """Plain PyTorch version of the compositor kernel, in the chunked
    cumprod formulation of the TPU kernel: within a chunk the transmittance
    after Gaussian g is T_run·Π_{j≤g}(1-α_j), and a Gaussian contributes
    iff that is ≥ 1e-4. All tiles advance together, chunk by chunk; a tile
    stops when its list is exhausted or its T is dead everywhere.

    Returns acc (t, P, 4), tfin (t, P, 1), tst (t, P, K/128) float32 and
    nexec (t,) int32, the outputs of the kernel.
    """
    t, _, K = records.shape
    nch = K // CHUNK
    P = tile_h * tile_w
    dev = records.device
    px, py = _pixel_basis(tile_h, tile_w, dev)
    px, py = px[None, :, None], py[None, :, None]

    need = torch.clamp(torch.div(counts.long() + CHUNK - 1, CHUNK, rounding_mode="floor"), max=nch)
    acc = torch.zeros(t, P, 4, dtype=torch.float32, device=dev)
    tst = torch.ones(t, P, nch, dtype=torch.float32, device=dev)
    T_run = torch.ones(t, P, 1, dtype=torch.float32, device=dev)
    nexec = torch.zeros(t, dtype=torch.int32, device=dev)
    running = torch.ones(t, dtype=torch.bool, device=dev)
    for c in range(nch):
        running = running & (c < need) & (T_run.amax(dim=(1, 2)) >= T_EPS)
        if not bool(running.any()):
            break
        B = records[:, :, c * CHUNK:(c + 1) * CHUNK]           # (t, 8, CH)
        C = colors[:, :3, c * CHUNK:(c + 1) * CHUNK]           # (t, 3, CH)
        u = px * B[:, 0:1] + py * B[:, 1:2] + B[:, 2:3]        # (t, P, CH)
        v = py * B[:, 3:4] + B[:, 4:5]
        araw = B[:, 5:6] * torch.exp(-0.5 * (u * u + v * v))
        alpha = torch.where(araw >= ALPHA_MIN, torch.clamp(araw, max=ALPHA_MAX),
                            torch.zeros_like(araw))
        om = 1.0 - alpha
        TT = T_run * torch.cumprod(om, dim=2)                  # T after each Gaussian
        contrib = TT >= T_EPS
        w = torch.where(contrib, alpha * TT / om, torch.zeros_like(TT))
        rgb = (w[:, :, None, :] * C[:, None, :, :]).sum(dim=-1)  # (t, P, 3)
        T_new = torch.where(contrib, TT, T_run).amin(dim=2, keepdim=True)

        run = running[:, None, None]
        tst[:, :, c] = torch.where(running[:, None], T_run[..., 0], tst[:, :, c])
        acc[..., :3] = torch.where(run, acc[..., :3] + rgb, acc[..., :3])
        T_run = torch.where(run, T_new, T_run)
        nexec += running.to(torch.int32)
    return acc, T_run, tst, nexec


def _check_tile(K: int, tile_h: int, tile_w: int) -> None:
    if K % CHUNK or K == 0:
        raise ValueError(f"K={K} must be a positive multiple of {CHUNK}")
    if not 0 < tile_h * tile_w <= MAX_TILE_PIXELS:
        raise ValueError(f"tile {tile_h}x{tile_w} has {tile_h * tile_w} pixels; "
                         f"the kernels take 1..{MAX_TILE_PIXELS}")


class CompositeFwd(CudaKernel):
    """Wrapper of the CUDA forward compositor; `launches` counts kernel
    launches (plain-version calls on the CPU do not count)."""

    def __init__(self):
        super().__init__("composite_fwd.cu", "composite_fwd", [PTR] * 7 + [INT] * 4)

    def launch(self, records, colors, counts, tile_h, tile_w):
        """Run the kernel on CUDA tensors; returns (acc, tfin, tst, nexec)."""
        t, rows, K = records.shape
        P = tile_h * tile_w
        if rows != 8 or colors.shape != (t, 4, K) or counts.shape != (t,):
            raise ValueError(
                f"records {tuple(records.shape)}, colors {tuple(colors.shape)}, "
                f"counts {tuple(counts.shape)} do not form (t,8,K), (t,4,K), (t,)"
            )
        _check_tile(K, tile_h, tile_w)
        dev = records.device
        check_tensors(dev, records=(records, torch.float32), colors=(colors, torch.float32),
                      counts=(counts, torch.int32))
        acc = torch.empty(t, P, 4, dtype=torch.float32, device=dev)
        tfin = torch.empty(t, P, 1, dtype=torch.float32, device=dev)
        tst = torch.empty(t, P, K // CHUNK, dtype=torch.float32, device=dev)
        nexec = torch.empty(t, dtype=torch.int32, device=dev)
        if t == 0:
            return acc, tfin, tst, nexec
        self.run(dev, counts.data_ptr(), records.data_ptr(), colors.data_ptr(),
                 acc.data_ptr(), tfin.data_ptr(), tst.data_ptr(), nexec.data_ptr(),
                 t, K, tile_h, tile_w)
        return acc, tfin, tst, nexec

    def __call__(self, records, colors, counts, tile_h: int = TILE_H, tile_w: int = TILE_W):
        if records.is_cuda:
            return self.launch(records, colors, counts, tile_h, tile_w)
        if records.device.type == "cpu":
            return composite_records_plain(records, colors, counts, tile_h, tile_w)
        raise RuntimeError(f"no compositor for device {records.device}")


composite_fwd = CompositeFwd()


def composite_bwd_plain(records, colors, tst, nexec, tfin, gout, gtfin,
                        tile_h: int = TILE_H, tile_w: int = TILE_W):
    """Plain PyTorch version of the backward kernel: the formulas of the TPU
    kernel (pallas_composite.py:188-251) chunk by chunk, back to front, on
    (t, P, 128) tensors, all tiles at once; a tile takes part in chunk c
    only if c < nexec. Returns drec (t, 8, K) and dcol (t, 4, K)."""
    t, _, K = records.shape
    nch = K // CHUNK
    dev = records.device
    px, py = _pixel_basis(tile_h, tile_w, dev)
    px, py = px[None, :, None], py[None, :, None]
    drec = torch.zeros(t, 8, K, dtype=torch.float32, device=dev)
    dcol = torch.zeros(t, 4, K, dtype=torch.float32, device=dev)
    dacc = gout[..., :3]                                       # (t, P, 3)
    bgterm = gtfin * tfin                                      # (t, P, 1)
    accum = torch.zeros_like(bgterm)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for c in reversed(range(nch)):
        run = c < nexec.long()                                 # (t,)
        if not bool(run.any()):
            continue
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        B = records[:, :, sl]
        C = colors[:, :3, sl]
        u = px * B[:, 0:1] + py * B[:, 1:2] + B[:, 2:3]        # (t, P, CH)
        v = py * B[:, 3:4] + B[:, 4:5]
        e = torch.exp(-0.5 * (u * u + v * v))
        araw = B[:, 5:6] * e
        alpha = torch.where(araw >= ALPHA_MIN, torch.clamp(araw, max=ALPHA_MAX), zero)
        om = 1.0 - alpha
        TT = tst[:, :, c:c + 1] * torch.cumprod(om, dim=2)
        contrib = TT >= T_EPS
        Tb = TT / om
        w = torch.where(contrib, alpha * Tb, zero)
        dwdot = dacc[..., 0:1] * C[:, 0:1] + dacc[..., 1:2] * C[:, 1:2] + dacc[..., 2:3] * C[:, 2:3]
        dcol_c = (dacc[..., :, None] * w[:, :, None, :]).sum(dim=1)  # (t, 3, CH)
        vchunk = dwdot * w
        sfx = torch.flip(torch.cumsum(torch.flip(vchunk, (2,)), dim=2), (2,)) - vchunk
        dalpha = torch.where(contrib, dwdot * Tb - (sfx + accum + bgterm) / om, zero)
        live = (araw >= ALPHA_MIN) & (araw < ALPHA_MAX)
        daraw = torch.where(live, dalpha, zero)
        dq2 = daraw * araw
        du, dv = -u * dq2, -v * dq2
        grads = torch.stack([(du * px).sum(1), (du * py).sum(1), du.sum(1),
                             (dv * py).sum(1), dv.sum(1), (daraw * e).sum(1)], dim=1)
        keep = run[:, None, None]
        drec[:, :6, sl] = torch.where(keep, grads, zero)
        dcol[:, :3, sl] = torch.where(keep, dcol_c, zero)
        accum = torch.where(keep, accum + vchunk.sum(dim=2, keepdim=True), accum)
    return drec, dcol


class CompositeBwd(CudaKernel):
    """Wrapper of the CUDA backward compositor; `launches` counts launches."""

    def __init__(self):
        super().__init__("composite_bwd.cu", "composite_bwd", [PTR] * 9 + [INT] * 4)

    def launch(self, records, colors, tst, nexec, tfin, gout, gtfin, tile_h, tile_w):
        """Run the kernel on CUDA tensors; returns (drec, dcol)."""
        t, rows, K = records.shape
        P = tile_h * tile_w
        shapes = {"colors": (colors, (t, 4, K)), "tst": (tst, (t, P, K // CHUNK)),
                  "nexec": (nexec, (t,)), "tfin": (tfin, (t, P, 1)),
                  "gout": (gout, (t, P, 4)), "gtfin": (gtfin, (t, P, 1))}
        bad = [n for n, (x, shape) in shapes.items() if tuple(x.shape) != shape]
        if rows != 8 or bad:
            raise ValueError(f"records {tuple(records.shape)} with {bad} of other shapes")
        _check_tile(K, tile_h, tile_w)
        dev = records.device
        f32 = torch.float32
        check_tensors(dev, records=(records, f32), colors=(colors, f32), tst=(tst, f32),
                      nexec=(nexec, torch.int32), tfin=(tfin, f32), gout=(gout, f32),
                      gtfin=(gtfin, f32))
        drec = torch.zeros(t, 8, K, dtype=f32, device=dev)
        dcol = torch.zeros(t, 4, K, dtype=f32, device=dev)
        if t == 0:
            return drec, dcol
        self.run(dev, nexec.data_ptr(), records.data_ptr(), colors.data_ptr(), tst.data_ptr(),
                 tfin.data_ptr(), gout.data_ptr(), gtfin.data_ptr(), drec.data_ptr(),
                 dcol.data_ptr(), t, K, tile_h, tile_w)
        return drec, dcol

    def __call__(self, records, colors, tst, nexec, tfin, gout, gtfin,
                 tile_h: int = TILE_H, tile_w: int = TILE_W):
        if records.is_cuda:
            return self.launch(records, colors, tst, nexec, tfin, gout, gtfin, tile_h, tile_w)
        if records.device.type == "cpu":
            return composite_bwd_plain(records, colors, tst, nexec, tfin, gout, gtfin,
                                       tile_h, tile_w)
        raise RuntimeError(f"no compositor for device {records.device}")


composite_bwd = CompositeBwd()


class CompositeCore(torch.autograd.Function):
    """(records, colors, counts) -> (acc, tfin) through the forward kernel;
    the backward kernel gives d(records) and d(colors), and counts get no
    gradient."""

    @staticmethod
    def forward(ctx, records, colors, counts, tile_h, tile_w):
        acc, tfin, tst, nexec = composite_fwd(records, colors, counts, tile_h, tile_w)
        ctx.save_for_backward(records, colors, tst, nexec, tfin)
        ctx.tile = (tile_h, tile_w)
        return acc, tfin

    @staticmethod
    def backward(ctx, gacc, gtfin):
        records, colors, tst, nexec, tfin = ctx.saved_tensors
        drec, dcol = composite_bwd(records, colors, tst, nexec, tfin, gacc.contiguous(),
                                   gtfin.contiguous(), *ctx.tile)
        return drec, dcol, None, None, None


def composite_tiles(
    pg: ProjectedGaussians,
    binning: TileBinning,
    background: torch.Tensor,
    image_shape: tuple[int, int],
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
) -> torch.Tensor:
    """Composite every tile and assemble the (3, h, w) image."""
    h, w = image_shape
    nty, ntx = binning.num_tiles_y, binning.num_tiles_x
    with span("raster.records", device=True):
        records, colors, counts = build_records(pg, binning, tile_h, tile_w)
    with span("raster.composite", device=True):
        acc, tfin = CompositeCore.apply(records, colors, counts, tile_h, tile_w)
    img = acc[..., :3].transpose(1, 2) + tfin.transpose(1, 2) * background[None, :, None]
    img = img.reshape(nty, ntx, 3, tile_h, tile_w).permute(2, 0, 3, 1, 4)
    img = img.reshape(3, nty * tile_h, ntx * tile_w)
    return img[:, :h, :w]
