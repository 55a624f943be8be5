"""Banked binning's stream gather: for every tile, the S slot windows of the
(group, depth)-sorted key and payload arrays, masked to the valid run and
the window shape, as the flat merge's inputs.

For tile t and slot s with offset (dy, dx), column j < budget_s + 128 of the
slot's window reads position pos = al[t, s]·128 + j, and

    valid  = lo[t, s] <= pos < hi[t, s]  and  dy < nyw  and  dx < nxw
             (win = gw >> 25, nxw = win & 3, nyw = win >> 2)
    packed = t << qbits | (key & qmask  if valid else qmask)
    gid    = gw & (2^25 - 1)            if valid else INVALID_GID

go to row t, column offs[s] + j of two (num_tiles, ncol) int32 outputs,
ncol = Σ_s (budget_s + 128). The window starts at al·128 and carries 128
extra columns, as the TPU kernel's aligned DMA windows do, so both give the
same arrays bit for bit; the sentinels sort behind every valid entry.

`gather_streams` launches the CUDA kernel (csrc/banked_gather.cu) for CUDA
tensors and runs `gather_streams_plain` for CPU tensors; on any other
device it raises. Banked binning pads key_sorted and gw_sorted past every
window (tiling._banked_streams). On the card the wrapper checks shapes only,
so a launch never waits for the card, and the kernel reads a position past
the end as no entry; on the CPU the wrapper also checks the padding.
"""
from __future__ import annotations

import torch

from ..cuda_kernel import INT, LONG, PTR, CudaKernel, check_tensors

ALIGN = 128
GID_BITS = 25
GID_MASK = (1 << GID_BITS) - 1
# The window shape lives in bits [GID_BITS, 31): callers gate
# nxw | nyw << 2 < WIN_LIMIT so the payload never reaches the sign bit.
WIN_LIMIT = 1 << (31 - GID_BITS)
INVALID_GID = 0x7FFFFFFF


def _layout(budgets):
    widths = [b + ALIGN for b in budgets]
    offs = [sum(widths[:i]) for i in range(len(widths))]
    return widths, offs, sum(widths)


def _check_args(key_sorted, gw_sorted, al, lo, hi, budgets, dydx, qbits, num_tiles):
    S = len(budgets)
    if S == 0 or len(dydx) != S:
        raise ValueError(f"{S} budgets and {len(dydx)} slot offsets")
    if any(b % ALIGN or b <= 0 for b in budgets):
        raise ValueError(f"budgets {budgets} must be positive multiples of {ALIGN}")
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


class BankedGather(CudaKernel):
    """Wrapper of the CUDA stream gather; `launches` counts kernel launches
    (plain-version calls on the CPU do not count)."""

    def __init__(self):
        super().__init__("banked_gather.cu", "banked_gather", [PTR] * 8 + [LONG] + [INT] * 4)
        self._slots = {}

    def _slot_table(self, budgets, dydx, device):
        """(4, S) int32 on the card: window width, column offset, dy, dx."""
        key = (tuple(budgets), tuple(dydx), device)
        if key not in self._slots:
            widths, offs, _ = _layout(budgets)
            rows = [widths, offs, [d[0] for d in dydx], [d[1] for d in dydx]]
            self._slots[key] = torch.tensor(rows, dtype=torch.int32, device=device).contiguous()
        return self._slots[key]

    def launch(self, key_sorted, gw_sorted, al, lo, hi, *, budgets, dydx, qbits, num_tiles):
        """Run the kernel on CUDA tensors; returns (packed, gid)."""
        _check_args(key_sorted, gw_sorted, al, lo, hi, budgets, dydx, qbits, num_tiles)
        dev = key_sorted.device
        i32 = torch.int32
        check_tensors(dev, key_sorted=(key_sorted, i32), gw_sorted=(gw_sorted, i32),
                      al=(al, i32), lo=(lo, i32), hi=(hi, i32))
        ncol = _layout(budgets)[2]
        packed = torch.empty(num_tiles, ncol, dtype=i32, device=dev)
        gid = torch.empty(num_tiles, ncol, dtype=i32, device=dev)
        if num_tiles == 0:
            return packed, gid
        slots = self._slot_table(budgets, dydx, dev)
        self.run(dev, key_sorted.data_ptr(), gw_sorted.data_ptr(), al.data_ptr(), lo.data_ptr(),
                 hi.data_ptr(), slots.data_ptr(), packed.data_ptr(), gid.data_ptr(),
                 key_sorted.shape[0], num_tiles, len(budgets), ncol, qbits)
        return packed, gid

    def __call__(self, key_sorted, gw_sorted, al, lo, hi, *, budgets, dydx, qbits, num_tiles):
        kw = dict(budgets=budgets, dydx=dydx, qbits=qbits, num_tiles=num_tiles)
        if key_sorted.is_cuda:
            return self.launch(key_sorted, gw_sorted, al, lo, hi, **kw)
        if key_sorted.device.type == "cpu":
            _check_args(key_sorted, gw_sorted, al, lo, hi, budgets, dydx, qbits, num_tiles)
            _check_padding(key_sorted, al, budgets, num_tiles)
            return gather_streams_plain(key_sorted, gw_sorted, al, lo, hi, **kw)
        raise RuntimeError(f"no stream gather for device {key_sorted.device}")


gather_streams = BankedGather()
