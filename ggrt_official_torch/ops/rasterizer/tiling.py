"""Tile binning for the rasterizer: sort, counting and banked modes, the
overflow statistics and the demand-driven capacity policy.

Each Gaussian is duplicated into the screen tiles its (mean-centred,
capped) AABB window covers, and every tile keeps its Gaussians front to
back. Two static caps keep the shapes fixed:

  * ``max_dup``      — tiles a single Gaussian may claim;
  * ``max_per_tile`` — per-tile list capacity K (front to back; overflow
                       drops the farthest Gaussians).

The three modes give the same lists where nothing truncates:

  * sort:     the (tile, quantized depth) pairs are packed into one int32
              key and sorted stably, so ties break by Gaussian id;
  * counting: one depth argsort of the Gaussians, then a stable sort of
              the duplicates by tile, which keeps depth order in a tile;
  * banked:   a fixed window shape, so every tile's candidates are S
              contiguous runs of ONE per-Gaussian (group, depth) sort,
              gathered by the banked-gather kernel and merged.

Tile geometry is (tile_h, tile_w) = (8, 128) by default.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...constants import device_constant
from ...utils.tracing import count
from . import banked_gather as bg
from .projection import ProjectedGaussians

TILE_H = 8
TILE_W = 128
DEPTH_BITS = 20          # quantized-depth key width (see _quantize_depth)
_MIN_DEPTH_BITS = 12     # below this the packed key cannot order depths
_BITS31 = 0x7FFFFFFF


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """max(x, lo) then min(., hi): the order jnp.clip applies when lo > hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _qbits(num_tiles: int) -> int:
    """Depth bits left in an int32 key above the tile index."""
    return min(DEPTH_BITS, 31 - (num_tiles + 1).bit_length())


def _quantize_depth(depth: torch.Tensor, visible: torch.Tensor, bits: int) -> torch.Tensor:
    """Monotone fixed-point depth key in [0, 2^bits), uniform over the
    visible depth range. Invisible entries get the max key so they sort
    behind everything."""
    lo = torch.where(visible, depth, 3.4e38).min()
    hi = torch.where(visible, depth, -3.4e38).max()
    span = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((depth - lo) / span, 0.0, 1.0) * ((1 << bits) - 2)
    q = q.to(torch.int32)
    return torch.where(visible, q, torch.full_like(q, (1 << bits) - 1))


def _sort_pairs(major: torch.Tensor, minor: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sort by (major, minor), two non-negative int32 keys, as one int64
    key; returns the minor keys in that order (jax.lax.sort with
    num_keys=2 keeps the second operand in the same order)."""
    packed = (major.long() << 31) | minor.long()
    return (torch.sort(packed, dim=dim).values & _BITS31).to(torch.int32)


class TileBinning(NamedTuple):
    gaussian_ids: torch.Tensor  # (num_tiles, K) int64, -1 padded, front to back
    counts: torch.Tensor        # (num_tiles,) int32
    num_tiles_y: int
    num_tiles_x: int


def _grid(image_shape, tile_h: int, tile_w: int):
    h, w = image_shape
    ntx = -(-w // tile_w)
    nty = -(-h // tile_h)
    return ntx, nty, ntx * nty


def _tile_aabb(pg: ProjectedGaussians, ntx: int, nty: int, tile_w: int, tile_h: int):
    """Per-Gaussian tile-index AABB (min inclusive, max exclusive) from the
    tight per-axis extents."""
    ex = pg.extent[:, 0]
    ey = pg.extent[:, 1]
    visible = pg.valid & (ex > 0.0) & (ey > 0.0)
    x0 = torch.clamp(((pg.mean2d[:, 0] - ex) / tile_w).to(torch.int32), 0, ntx)
    x1 = torch.clamp(
        torch.floor((pg.mean2d[:, 0] + ex + tile_w - 1) / tile_w).to(torch.int32), 0, ntx
    )
    y0 = torch.clamp(((pg.mean2d[:, 1] - ey) / tile_h).to(torch.int32), 0, nty)
    y1 = torch.clamp(
        torch.floor((pg.mean2d[:, 1] + ey + tile_h - 1) / tile_h).to(torch.int32), 0, nty
    )
    visible = visible & (x1 > x0) & (y1 > y0)
    return x0, x1, y0, y1, visible


def _centred_origin(pg, x0, x1, y0, y1, nxw, nyw, tile_w: int, tile_h: int):
    """Origin of an (nxw, nyw) window centred on the tile of the mean and
    kept inside the AABB."""
    tx = _clip((pg.mean2d[:, 0] / tile_w).to(torch.int32), x0, x1 - 1)
    ty = _clip((pg.mean2d[:, 1] / tile_h).to(torch.int32), y0, y1 - 1)
    x0w = _clip(tx - _floordiv(nxw - 1, 2), x0, x1 - nxw)
    y0w = _clip(ty - _floordiv(nyw - 1, 2), y0, y1 - nyw)
    return x0w, y0w


def _dup_window(pg, x0, x1, y0, y1, tile_w: int, tile_h: int, max_dup: int):
    """Shrink each Gaussian's tile AABB to at most max_dup cells, centred on
    the tile containing its mean. Returns (x0', y0', nx', ny')."""
    nx = x1 - x0
    ny = y1 - y0
    nxw = torch.clamp(nx, max=max_dup)
    nyw = torch.minimum(ny, _floordiv(torch.full_like(nxw, max_dup), torch.clamp(nxw, min=1)))
    nyw = torch.maximum(nyw, torch.clamp(ny, max=1))
    x0w, y0w = _centred_origin(pg, x0, x1, y0, y1, nxw, nyw, tile_w, tile_h)
    return x0w, y0w, nxw, nyw


def _dup_window_banked(pg, x0, x1, y0, y1, tile_w: int, tile_h: int, win_x: int, win_y: int):
    """Fixed-shape (win_y rows x win_x columns) mean-centred window: every
    duplicate slot s then has the fixed offset (s // win_x, s % win_x) from
    the window origin, which makes per-tile lists contiguous runs of one
    per-Gaussian sort (see bin_gaussians_banked)."""
    nxw = torch.clamp(x1 - x0, max=win_x)
    nyw = torch.clamp(y1 - y0, max=win_y)
    x0w, y0w = _centred_origin(pg, x0, x1, y0, y1, nxw, nyw, tile_w, tile_h)
    return x0w, y0w, nxw, nyw


def _window_tiles(x0w, y0w, nxw, nyw, visible, ntx: int, num_tiles: int, max_dup: int):
    """(g, max_dup) tile of each duplicate slot, enumerated row-major over
    the window; num_tiles where the slot lies outside it."""
    slot = torch.arange(max_dup, dtype=torch.int32, device=x0w.device)
    nx_safe = torch.clamp(nxw, min=1)
    dy = _floordiv(slot[None, :], nx_safe[:, None])
    dx = slot[None, :] - dy * nx_safe[:, None]
    tile_id = (y0w[:, None] + dy) * ntx + (x0w[:, None] + dx)
    in_box = (slot[None, :] < (nxw * nyw)[:, None]) & visible[:, None]
    return torch.where(in_box, tile_id, torch.full_like(tile_id, num_tiles)).to(torch.int32)


def _lists(starts: torch.Tensor, sorted_ids: torch.Tensor, max_per_tile: int):
    """Front-K ids of each tile's run [starts[t], starts[t+1]) of a list
    sorted by tile; -1 past the run. While the profiler records, counts the
    duplicate keys that name a tile (`raster.keys`: the sort's entries ahead
    of its padding) and the (tile, Gaussian) pairs the lists keep within K
    (`raster.kept`), as the tensors that hold them: counting launches
    nothing."""
    counts = torch.clamp(starts[1:] - starts[:-1], max=max_per_tile)
    count("raster.keys", starts[-1])
    count("raster.kept", counts)
    k = torch.arange(max_per_tile, dtype=torch.int32, device=starts.device)
    positions = torch.clamp(starts[:-1, None] + k[None, :], 0, sorted_ids.shape[0] - 1)
    in_seg = k[None, :] < counts[:, None]
    ids = sorted_ids[positions.long()].long()
    return torch.where(in_seg, ids, torch.full_like(ids, -1)), counts


def bin_gaussians(
    pg: ProjectedGaussians,
    image_shape: tuple[int, int],
    max_dup: int = 32,
    max_per_tile: int = 1024,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
) -> TileBinning:
    ntx, nty, num_tiles = _grid(image_shape, tile_h, tile_w)
    g = pg.mean2d.shape[0]
    dev = pg.mean2d.device
    qbits = _qbits(num_tiles)

    with torch.no_grad():
        x0, x1, y0, y1, visible = _tile_aabb(pg, ntx, nty, tile_w, tile_h)
        x0w, y0w, nxw, nyw = _dup_window(pg, x0, x1, y0, y1, tile_w, tile_h, max_dup)
        flat_tile = _window_tiles(x0w, y0w, nxw, nyw, visible, ntx, num_tiles, max_dup).reshape(-1)
        tile_range = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev)

        if qbits >= _MIN_DEPTH_BITS:
            # Packed (tile, quantized depth) key. The stable sort's
            # permutation is the flat duplicate index gid·max_dup + slot, so
            # ties break by Gaussian id and the Gaussian is recovered at the
            # selected slots.
            q = _quantize_depth(pg.depth, visible, qbits)
            flat_q = q[:, None].expand(g, max_dup).reshape(-1)
            packed_sorted, didx_sorted = torch.sort((flat_tile << qbits) | flat_q, stable=True)
            starts = torch.searchsorted(
                packed_sorted, (tile_range << qbits).contiguous(), side="left", out_int32=True
            )
            ids, counts = _lists(starts, _floordiv(didx_sorted, max_dup), max_per_tile)
        else:
            # Huge images (2^19 - 1 tiles or more): too few bits for a packed
            # key, so sort (tile, exact depth rank) as one int64 key. The
            # rank is a bijection onto the Gaussians, so the id comes back
            # from it.
            order = torch.argsort(
                torch.where(visible, pg.depth, torch.full_like(pg.depth, float("inf"))), stable=True
            )
            rank = torch.empty_like(order)
            rank[order] = torch.arange(g, device=dev)
            flat_rank = rank[:, None].expand(g, max_dup).reshape(-1)
            key_sorted = torch.sort((flat_tile.long() << 32) | flat_rank).values
            tile_sorted = (key_sorted >> 32).to(torch.int32)
            starts = torch.searchsorted(tile_sorted, tile_range, side="left", out_int32=True)
            ids, counts = _lists(starts, order[key_sorted & 0xFFFFFFFF], max_per_tile)
    return TileBinning(gaussian_ids=ids, counts=counts, num_tiles_y=nty, num_tiles_x=ntx)


def binning_overflow_stats(
    pg: ProjectedGaussians,
    image_shape: tuple[int, int],
    max_dup: int = 32,
    max_per_tile: int = 1024,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
) -> dict:
    """What the static caps drop: the (Gaussian, tile) pairs wanted, those
    dropped by max_dup and by max_per_tile, the recall, and the largest
    per-tile demand after the dup cap. Values are 0-d tensors."""
    ntx, nty, num_tiles = _grid(image_shape, tile_h, tile_w)
    with torch.no_grad():
        x0, x1, y0, y1, visible = _tile_aabb(pg, ntx, nty, tile_w, tile_h)
        x0w, y0w, nxw, nyw = _dup_window(pg, x0, x1, y0, y1, tile_w, tile_h, max_dup)
        zero = torch.zeros_like(x0)
        per_gauss = torch.where(visible, (x1 - x0) * (y1 - y0), zero)
        kept_gauss = torch.where(visible, nxw * nyw, zero)
        wanted = per_gauss.sum()
        dup_dropped = (per_gauss - kept_gauss).sum()
        tile_id = _window_tiles(x0w, y0w, nxw, nyw, visible, ntx, num_tiles, max_dup)
        per_tile = torch.bincount(tile_id.reshape(-1).long(), minlength=num_tiles + 1)[:num_tiles]
        tile_dropped = torch.clamp(per_tile - max_per_tile, min=0).sum()
        kept = wanted - dup_dropped - tile_dropped
        return {
            "pairs_wanted": wanted,
            "dropped_by_max_dup": dup_dropped,
            "dropped_by_max_per_tile": tile_dropped,
            "recall": kept.float() / torch.clamp(wanted, min=1).float(),
            "max_tile_demand": per_tile.max(),
        }


def recommend_max_per_tile(
    pg: ProjectedGaussians,
    image_shape: tuple[int, int],
    max_dup: int = 8,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
    floor: int = 256,
    cap: int = 8192,
) -> dict:
    """Demand-driven per-tile capacity: K = the next power of two covering
    the largest per-tile demand (full recall), clipped to [floor, cap];
    `clipped` says the cap bit. For a K that may undercut demand, see
    `api.choose_max_per_tile`, which measures the quality at each K.

    Returns {"max_per_tile", "max_tile_demand", "clipped", "mean_alpha"}.
    """
    stats = binning_overflow_stats(
        pg, image_shape, max_dup=max_dup, max_per_tile=1, tile_h=tile_h, tile_w=tile_w
    )
    demand = int(stats["max_tile_demand"])
    vis = pg.valid
    nvis = torch.clamp(vis.float().sum(), min=1.0)
    mean_alpha = float(torch.where(vis, pg.opacity, torch.zeros_like(pg.opacity)).sum() / nvis)
    k = max(floor, 1 << (max(demand, 1) - 1).bit_length())
    return {
        "max_per_tile": int(min(k, cap)),
        "max_tile_demand": demand,
        "clipped": bool(k > cap),
        "mean_alpha": mean_alpha,
    }


def bin_gaussians_counting(
    pg: ProjectedGaussians,
    image_shape: tuple[int, int],
    max_dup: int = 8,
    max_per_tile: int = 1024,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
) -> TileBinning:
    """One depth argsort of the Gaussians, then a stable sort of their
    duplicates by tile: entries are enumerated in depth order, so each
    tile's run stays front to back. The same lists as `bin_gaussians` (the
    same quantized key, ties by Gaussian id)."""
    ntx, nty, num_tiles = _grid(image_shape, tile_h, tile_w)
    dev = pg.mean2d.device
    qbits = _qbits(num_tiles)
    with torch.no_grad():
        x0, x1, y0, y1, visible = _tile_aabb(pg, ntx, nty, tile_w, tile_h)
        x0w, y0w, nxw, nyw = _dup_window(pg, x0, x1, y0, y1, tile_w, tile_h, max_dup)
        if qbits >= _MIN_DEPTH_BITS:
            depth_key = _quantize_depth(pg.depth, visible, qbits)
        else:
            depth_key = torch.where(visible, pg.depth, torch.full_like(pg.depth, float("inf")))
        order = torch.argsort(depth_key, stable=True)
        tile_flat = _window_tiles(x0w[order], y0w[order], nxw[order], nyw[order], visible[order],
                                  ntx, num_tiles, max_dup).reshape(-1)
        tile_sorted, perm = torch.sort(tile_flat, stable=True)
        tile_range = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev)
        starts = torch.searchsorted(tile_sorted, tile_range, side="left", out_int32=True)
        ids, counts = _lists(starts, order[_floordiv(perm, max_dup)], max_per_tile)
    return TileBinning(gaussian_ids=ids, counts=counts, num_tiles_y=nty, num_tiles_x=ntx)


class BankedStreams(NamedTuple):
    """Banked binning's per-(tile, slot) stream descriptors over the
    (group, depth)-sorted Gaussians: the arguments of `banked_lists`."""

    key_sorted: torch.Tensor   # (n_pad,) int32: group << qbits | q, 0-padded
    gw_sorted: torch.Tensor    # (n_pad,) int32: gid | win << 25, INVALID_GID-padded
    al: torch.Tensor           # (num_tiles, S) int32: window start / 128
    lo: torch.Tensor           # (num_tiles, S) int32: the valid run is [lo, hi)
    hi: torch.Tensor
    budgets: tuple             # S python ints, multiples of 128
    dydx: tuple                # S (dy, dx) slot offsets
    qbits: int
    num_tiles: int


def _banked_budgets(K: int, win_x: int, S: int):
    """Per-slot stream budgets rounded up to 128. A stream for offset
    (dy, dx) holds every Gaussian whose window origin is that group, but
    only those with nyw > dy and nxw > dx are valid for the tile, so a
    front-L cut can drop valid far entries. The (0, 0) stream is undiluted
    and the row below nearly so: both get the full K; the side and deeper
    streams are rarer and taper to K/4 and K/8."""
    def budget(dy, dx):
        if dx == 0 and dy <= 1:
            return K
        if dx == 0 and dy == 2 or (dx == 1 and dy == 0):
            return K // 4
        return K // 8

    dydx = tuple((s // win_x, s % win_x) for s in range(S))
    return tuple(-(-budget(dy, dx) // bg.ALIGN) * bg.ALIGN for dy, dx in dydx), dydx


def banked_uses_kernel(num_gaussians: int, ntx: int, max_dup: int, max_per_tile: int,
                       merge: str = "flat") -> bool:
    """The banked kernel's gate: a flat merge, ids below 2^25, a window shape
    nxw | nyw << 2 that fits the 6 payload bits above them, and a block's
    shared memory for the budgets within the card's 232,448 bytes
    (banked_gather.smem_bytes). It fails at max_dup 32, at max_dup 16 on a
    one-tile-wide image, and at max_dup 8 above K 4224 (window 2x4) or 4480
    (window 1x8)."""
    win_x = 1 if ntx == 1 else 2
    win_y = max_dup // win_x
    budgets, _ = _banked_budgets(max_per_tile, win_x, win_x * win_y)
    return (merge in ("auto", "flat") and num_gaussians < (1 << bg.GID_BITS)
            and (win_x | (win_y << 2)) < bg.WIN_LIMIT
            and bg.smem_bytes(budgets) <= bg.SMEM_LIMIT)


class _Banked(NamedTuple):
    ntx: int
    nty: int
    num_tiles: int
    qbits: int
    budgets: tuple
    dydx: tuple
    key_sorted: torch.Tensor   # (g,) int32
    gid_sorted: torch.Tensor   # (g,) int32
    win_sorted: torch.Tensor   # (g,) int32: nxw | nyw << 2
    grp_ok: torch.Tensor       # (num_tiles, S) bool: the source group is in the image
    seg_lo: torch.Tensor       # (num_tiles, S) int32: start of the source group's run
    seg_total: torch.Tensor    # (num_tiles, S) int32: its length


def _banked_sort(pg, image_shape, max_dup, max_per_tile, tile_h, tile_w) -> _Banked:
    """The one per-Gaussian sort by (window-origin group, depth) and, for
    each (tile, slot), the run of its source group."""
    ntx, nty, num_tiles = _grid(image_shape, tile_h, tile_w)
    dev = pg.mean2d.device
    win_x = 1 if ntx == 1 else 2
    win_y = max_dup // win_x
    qbits = _qbits(num_tiles)
    budgets, dydx = _banked_budgets(max_per_tile, win_x, win_x * win_y)

    x0, x1, y0, y1, visible = _tile_aabb(pg, ntx, nty, tile_w, tile_h)
    x0w, y0w, nxw, nyw = _dup_window_banked(pg, x0, x1, y0, y1, tile_w, tile_h, win_x, win_y)
    visible = visible & (nxw > 0) & (nyw > 0)
    q = _quantize_depth(pg.depth, visible, qbits)
    group = torch.where(visible, y0w * ntx + x0w, torch.full_like(x0w, num_tiles))
    # Stable: ties in (group, depth) keep Gaussian-id order, as
    # jax.lax.sort (stable by default) does.
    key_sorted, order = torch.sort((group << qbits) | q, stable=True)
    win_sorted = (nxw | (nyw << 2))[order]

    grp_range = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(key_sorted, (grp_range << qbits).contiguous(), side="left",
                                out_int32=True)
    t_idx = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    r = _floordiv(t_idx, ntx)
    c = t_idx - r * ntx
    dy = device_constant(tuple(d[0] for d in dydx), torch.int32, dev)
    dx = device_constant(tuple(d[1] for d in dydx), torch.int32, dev)
    src_r = r[:, None] - dy[None, :]
    src_c = c[:, None] - dx[None, :]
    grp_ok = (src_r >= 0) & (src_c >= 0)
    grp = torch.where(grp_ok, src_r * ntx + src_c, torch.full_like(src_r, num_tiles)).long()
    seg_lo = starts[grp]
    # An out-of-image source takes the group num_tiles, whose end index
    # num_tiles + 1 lies past `starts`: clamp it (JAX clamps the gather
    # there), so that run is empty.
    seg_total = starts[torch.clamp(grp + 1, max=num_tiles)] - seg_lo
    return _Banked(ntx, nty, num_tiles, qbits, budgets, dydx, key_sorted,
                   order.to(torch.int32), win_sorted, grp_ok, seg_lo, seg_total)


def _banked_streams(b: _Banked) -> BankedStreams:
    g = b.key_sorted.shape[0]
    L = device_constant(tuple(b.budgets), torch.int32, b.key_sorted.device)[None, :]
    eff = torch.where(b.grp_ok, torch.minimum(b.seg_total, L), torch.zeros_like(b.seg_total))
    # Padded so that every window [al·128, al·128 + budget + 128) lies
    # inside: al·128 <= lo <= g, so a window ends by g + max(budgets) + 128
    # <= n_pad. The gather's outputs equal the TPU kernel's only with it.
    n_pad = -(-(g + max(b.budgets) + bg.ALIGN) // bg.ALIGN) * bg.ALIGN
    gw = b.gid_sorted | (b.win_sorted << bg.GID_BITS)
    return BankedStreams(
        key_sorted=torch.nn.functional.pad(b.key_sorted, (0, n_pad - g)),
        gw_sorted=torch.nn.functional.pad(gw, (0, n_pad - g), value=bg.INVALID_GID),
        al=_floordiv(b.seg_lo, bg.ALIGN).contiguous(), lo=b.seg_lo.contiguous(),
        hi=(b.seg_lo + eff).contiguous(),
        budgets=b.budgets, dydx=b.dydx, qbits=b.qbits, num_tiles=b.num_tiles,
    )


def banked_streams(
    pg: ProjectedGaussians,
    image_shape: tuple[int, int],
    max_dup: int = 8,
    max_per_tile: int = 1024,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
) -> BankedStreams:
    """The inputs `bin_gaussians_banked` gives the banked-gather kernel."""
    with torch.no_grad():
        return _banked_streams(_banked_sort(pg, image_shape, max_dup, max_per_tile, tile_h, tile_w))


def bin_gaussians_banked(
    pg: ProjectedGaussians,
    image_shape: tuple[int, int],
    max_dup: int = 8,
    max_per_tile: int = 1024,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
    merge: str = "flat",
) -> TileBinning:
    """ONE per-Gaussian sort instead of the (g · max_dup)-entry pair sort.

    With a fixed window shape (win_y x win_x, win_y·win_x = max_dup), slot s
    always means offset (dy, dx) = (s // win_x, s % win_x) from the window
    origin. Sort the Gaussians once by (window-origin group, depth); then
    for any tile (r, c) and slot s the candidates are exactly the
    contiguous run of group (r - dy, c - dx), already front to back. Each
    tile gathers its S runs, each cut to its budget (the front K of the
    merge lies in the union of the streams' fronts), and merges them by
    (depth, Gaussian id).

    merge "flat" or "auto" takes the banked kernel where `banked_uses_kernel`
    holds (on CPU tensors its plain version: the gathered columns and one
    flat sort); "sort", or outside the gate, gathers slot by slot and merges
    with a per-tile sort. Both give the same lists.
    """
    K = max_per_tile
    g = pg.mean2d.shape[0]
    dev = pg.mean2d.device
    with torch.no_grad():
        b = _banked_sort(pg, image_shape, max_dup, K, tile_h, tile_w)
        num_tiles, qbits = b.num_tiles, b.qbits
        if banked_uses_kernel(g, b.ntx, max_dup, K, merge):
            s = _banked_streams(b)
            ids, counts = bg.banked_lists(
                s.key_sorted, s.gw_sorted, s.al, s.lo, s.hi, budgets=s.budgets, dydx=s.dydx,
                qbits=qbits, num_tiles=num_tiles, max_per_tile=K)
            return TileBinning(gaussian_ids=ids, counts=counts, num_tiles_y=b.nty,
                               num_tiles_x=b.ntx)
        qmask = (1 << qbits) - 1
        q_sorted = b.key_sorted & qmask
        q_cols, gid_cols = [], []
        for s, (L, (dy, dx)) in enumerate(zip(b.budgets, b.dydx)):
            k_r = torch.arange(L, dtype=torch.int32, device=dev)
            length = torch.clamp(b.seg_total[:, s], max=L)
            pos = torch.clamp(b.seg_lo[:, s, None] + k_r[None, :], 0, g - 1).long()
            win_at = b.win_sorted[pos]
            valid = ((k_r[None, :] < length[:, None]) & b.grp_ok[:, s:s + 1]
                     & (dy < (win_at >> 2)) & (dx < (win_at & 3)))
            q_cols.append(torch.where(valid, q_sorted[pos], qmask))
            gid_cols.append(torch.where(valid, b.gid_sorted[pos], bg.INVALID_GID))
        q_all = torch.cat(q_cols, dim=1)
        gid_all = torch.cat(gid_cols, dim=1)
        if merge in ("flat", "auto"):
            tile_col = torch.arange(num_tiles, dtype=torch.int32, device=dev)[:, None]
            gid_fin = _sort_pairs(((tile_col << qbits) | q_all).reshape(-1),
                                  gid_all.reshape(-1)).reshape(num_tiles, -1)
        else:
            gid_fin = _sort_pairs(q_all, gid_all, dim=1)

        ids, counts = bg.front_lists(gid_fin, gid_all, K)
    return TileBinning(gaussian_ids=ids, counts=counts, num_tiles_y=b.nty, num_tiles_x=b.ntx)
