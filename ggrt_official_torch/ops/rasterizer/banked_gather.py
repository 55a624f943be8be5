"""Banked binning's per-tile lists: for every tile, the S slot windows of
the (group, depth)-sorted key and payload streams, masked to the valid run
and the window shape, merged front to back into the tile's first K
Gaussian ids.

For tile t and slot s with offset (dy, dx), column j < budget_s + 128 of the
slot's window reads position pos = al[t, s]·128 + j, and

    valid  = lo[t, s] <= pos < hi[t, s]  and  dy < nyw  and  dx < nxw
             (win = gw >> 25, nxw = win & 3, nyw = win >> 2)
    packed = t << qbits | (key & qmask  if valid else qmask)
    gid    = gw & (2^25 - 1)            if valid else INVALID_GID

`gather_streams_plain` writes them to row t, column offs[s] + j of two
(num_tiles, ncol) int32 arrays, ncol = Σ_s (budget_s + 128): the TPU
kernel's layout (windows at al·128 with 128 extra columns), so both give the
same arrays bit for bit; the sentinels sort behind every valid entry.
`banked_lists_plain` sorts each tile's columns by (packed, gid) and keeps the
first K valid gids: the tile's (ids, counts).

`banked_lists` launches the CUDA kernel (csrc/banked_gather.cu) for CUDA
tensors, which stages the windows in shared memory and merges the slots'
sorted runs by rank, with the same lists bit for bit; for CPU tensors it
runs `banked_lists_plain`; on any other device it raises. Banked binning
pads key_sorted and gw_sorted past every window (tiling._banked_streams).
On the card the wrapper checks shapes and alignment only, so a launch never
waits for the card, and the kernel reads a position past the end as no
entry; on the CPU the wrapper also checks the padding.
"""
from __future__ import annotations

import ctypes

import torch

from ..cuda_kernel import INT, LONG, PTR, CudaKernel, check_tensors

ALIGN = 128
GID_BITS = 25
GID_MASK = (1 << GID_BITS) - 1
# The window shape lives in bits [GID_BITS, 31): callers gate
# nxw | nyw << 2 < WIN_LIMIT so the payload never reaches the sign bit.
WIN_LIMIT = 1 << (31 - GID_BITS)
INVALID_GID = 0x7FFFFFFF
_BITS31 = 0x7FFFFFFF
# The kernel's slot table holds at most MAX_SLOTS slots (the window gate
# admits win 2x15 at most), and a block at most SMEM_LIMIT bytes of shared
# memory (an H100 SM's 227 KB for one block).
MAX_SLOTS = 32
SMEM_LIMIT = 232_448
_SMEM_HEADER = 1024


def _ncol(budgets) -> int:
    """Window columns per tile: Σ (budget + 128)."""
    return sum(budgets) + ALIGN * len(budgets)


def smem_bytes(budgets) -> int:
    """Shared memory of one kernel block: a 1 KB header, the key and payload
    windows (8·ncol) and the compacted runs (8·ncol: a run holds at most
    its window)."""
    return _SMEM_HEADER + 16 * _ncol(budgets)


def _check_args(key_sorted, gw_sorted, al, lo, hi, budgets, dydx, qbits, num_tiles, max_per_tile):
    S = len(budgets)
    if not 0 < S <= MAX_SLOTS or len(dydx) != S:
        raise ValueError(f"{S} budgets and {len(dydx)} slot offsets")
    if any(b % ALIGN or b <= 0 for b in budgets):
        raise ValueError(f"budgets {budgets} must be positive multiples of {ALIGN}")
    if not 0 < max_per_tile <= _ncol(budgets):
        raise ValueError(f"max_per_tile {max_per_tile} exceeds the {_ncol(budgets)} columns")
    if not 0 < qbits <= 20 or (num_tiles + 1).bit_length() + qbits > 31:
        raise ValueError(f"qbits={qbits} with {num_tiles} tiles does not fit an int32 key")
    for name, x in (("al", al), ("lo", lo), ("hi", hi)):
        if tuple(x.shape) != (num_tiles, S):
            raise ValueError(f"{name} {tuple(x.shape)} is not ({num_tiles}, {S})")
    if key_sorted.dim() != 1 or key_sorted.shape != gw_sorted.shape:
        raise ValueError(f"key_sorted {tuple(key_sorted.shape)} and gw_sorted "
                         f"{tuple(gw_sorted.shape)} are not one (n_pad,) shape")


def _check_padding(key_sorted, al, budgets, num_tiles):
    """Every window [al·128, al·128 + budget + 128) lies inside the streams
    (reads max(al), so only the CPU path checks it)."""
    last = int(al.max()) * ALIGN + max(budgets) + ALIGN if num_tiles else 0
    if last > key_sorted.shape[0]:
        raise ValueError("key_sorted/gw_sorted are not padded past the last window")


def gather_streams_plain(key_sorted, gw_sorted, al, lo, hi, *, budgets, dydx, qbits, num_tiles):
    """Plain PyTorch version: index grids of (num_tiles, w_s), slot by slot."""
    qmask = (1 << qbits) - 1
    dev = key_sorted.device
    tile_hi = (torch.arange(num_tiles, dtype=torch.int32, device=dev) << qbits)[:, None]
    packed, gid = [], []
    for s, (L, (dy, dx)) in enumerate(zip(budgets, dydx)):
        pos = al[:, s, None].long() * ALIGN + torch.arange(L + ALIGN, device=dev)[None, :]
        key = key_sorted[pos]
        gw = gw_sorted[pos]
        win = gw >> GID_BITS
        valid = ((pos >= lo[:, s, None]) & (pos < hi[:, s, None])
                 & (dy < (win >> 2)) & (dx < (win & 3)))
        packed.append(tile_hi | torch.where(valid, key & qmask, qmask))
        gid.append(torch.where(valid, gw & GID_MASK, INVALID_GID))
    return torch.cat(packed, dim=1), torch.cat(gid, dim=1)


def _sort_pairs(major, minor):
    """tiling._sort_pairs over the last dim (a copy: tiling imports this
    module): sort by (major, minor) as one int64 key, return the minors."""
    packed = (major.long() << 31) | minor.long()
    return (torch.sort(packed, dim=-1).values & _BITS31).to(torch.int32)


def banked_lists_plain(key_sorted, gw_sorted, al, lo, hi, *, budgets, dydx, qbits, num_tiles,
                       max_per_tile):
    """Plain PyTorch version: the gathered columns, one flat sort by (packed,
    gid) (the tile index sits above the depth in `packed`, so every tile's
    columns are ordered in place), and the front-K cut. Returns ids
    (num_tiles, K) int64, -1 padded, and counts (num_tiles,) int32."""
    K = max_per_tile
    packed, gid = gather_streams_plain(key_sorted, gw_sorted, al, lo, hi, budgets=budgets,
                                       dydx=dydx, qbits=qbits, num_tiles=num_tiles)
    gid_fin = _sort_pairs(packed.reshape(-1), gid.reshape(-1)).reshape(num_tiles, -1)
    return front_lists(gid_fin, gid, K)


def front_lists(gid_fin, gid_cols, K):
    """The front-K cut of each tile's merged columns: ids (T, K) int64, -1
    from min(n_valid, K) on, and counts (T,) int32 = min(n_valid, K), where
    n_valid counts the valid entries (not INVALID_GID) of row t of
    gid_cols and gid_fin holds them first, in order."""
    counts = torch.clamp((gid_cols != INVALID_GID).sum(dim=1, dtype=torch.int32), max=K)
    k = torch.arange(K, device=gid_fin.device)
    return torch.where(k[None, :] < counts[:, None], gid_fin[:, :K].long(), -1), counts


class BankedLists(CudaKernel):
    """Wrapper of the CUDA per-tile gather-and-merge; `launches` counts kernel
    launches (plain-version calls on the CPU do not count)."""

    def __init__(self):
        super().__init__("banked_gather.cu", "banked_lists", [PTR] * 8 + [LONG] + [INT] * 4)

    def launch(self, key_sorted, gw_sorted, al, lo, hi, *, budgets, dydx, qbits, num_tiles,
               max_per_tile):
        """Run the kernel on CUDA tensors; returns (ids, counts)."""
        _check_args(key_sorted, gw_sorted, al, lo, hi, budgets, dydx, qbits, num_tiles, max_per_tile)
        dev = key_sorted.device
        i32 = torch.int32
        check_tensors(dev, key_sorted=(key_sorted, i32), gw_sorted=(gw_sorted, i32),
                      al=(al, i32), lo=(lo, i32), hi=(hi, i32))
        for name, x in (("key_sorted", key_sorted), ("gw_sorted", gw_sorted)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary (bulk copies)")
        K = max_per_tile
        smem = smem_bytes(budgets)   # the kernel's own count, kHeader + 16·ncol
        if smem > SMEM_LIMIT:
            raise ValueError(f"budgets {budgets} need {smem} bytes of shared memory, over "
                             f"{SMEM_LIMIT}")
        ids = torch.empty(num_tiles, K, dtype=torch.long, device=dev)
        counts = torch.empty(num_tiles, dtype=i32, device=dev)
        if num_tiles == 0:
            return ids, counts
        table = (ctypes.c_int * (3 * len(budgets)))(
            *(v for b, (dy, dx) in zip(budgets, dydx) for v in (b + ALIGN, dy, dx)))
        self.run(dev, key_sorted.data_ptr(), gw_sorted.data_ptr(), al.data_ptr(), lo.data_ptr(),
                 hi.data_ptr(), ids.data_ptr(), counts.data_ptr(), ctypes.addressof(table),
                 key_sorted.shape[0], num_tiles, len(budgets), K, qbits)
        return ids, counts

    def __call__(self, key_sorted, gw_sorted, al, lo, hi, *, budgets, dydx, qbits, num_tiles,
                 max_per_tile):
        kw = dict(budgets=budgets, dydx=dydx, qbits=qbits, num_tiles=num_tiles,
                  max_per_tile=max_per_tile)
        if key_sorted.is_cuda:
            return self.launch(key_sorted, gw_sorted, al, lo, hi, **kw)
        if key_sorted.device.type == "cpu":
            _check_args(key_sorted, gw_sorted, al, lo, hi, budgets, dydx, qbits, num_tiles,
                        max_per_tile)
            _check_padding(key_sorted, al, budgets, num_tiles)
            return banked_lists_plain(key_sorted, gw_sorted, al, lo, hi, **kw)
        raise RuntimeError(f"no banked lists for device {key_sorted.device}")


banked_lists = BankedLists()
